"""A tiny copy of the benchmark's data files for CPU tests, found by
name like the benchmark's own: for each configuration `tiny/<config>.json`
holds what the tiny copy changes (its sizes cut to a few thousand SNPs
and a few hundred samples, and the parameters that must follow them),
merged key by key into the configuration; for each cell
`tiny/limits/<cell>.json` holds its limits at that size, which take the
place of its own (those are set from chip readings)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import harness

# Where the tiny files sit under a root, as under the repository's.
TINY = Path("benchmark") / "tests" / "tiny"
SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")


def one_chip(spec: dict = SPEC) -> list:
    """The cells of one chip, as the CPU tests run them."""
    return [w["name"] for w in spec["workloads"] if w["chips"] == 1]


def merged(base: dict, over: dict) -> dict:
    """`base` with `over`'s keys put in, nested objects merged key by key."""
    out = dict(base)
    for key, val in over.items():
        both = isinstance(val, dict) and isinstance(out.get(key), dict)
        out[key] = merged(out[key], val) if both else val
    return out


def tiny_root(tmp: Path, src: Path = harness.ROOT) -> Path:
    """A root holding `src`'s BENCHMARK.json and benchmark/{configs,
    traffic,limits,tests/tiny}, each configuration cut by its tiny file
    and each cell's limits its tiny ones."""
    root = tmp / "root"
    (root / "benchmark").mkdir(parents=True)
    shutil.copy(src / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("traffic", "limits", "configs"):
        shutil.copytree(src / "benchmark" / sub, root / "benchmark" / sub)
    shutil.copytree(src / TINY, root / TINY)
    spec = spec_of(root)
    for conf in spec["configs"]:
        p = root / conf["file"]
        cut = harness.load_json(root / TINY / f"{conf['name']}.json")
        p.write_text(json.dumps(merged(harness.load_json(p), cut)))
    for w in spec["workloads"]:
        shutil.copy(root / TINY / "limits" / f"{w['name']}.json",
                    root / "benchmark" / "limits" / f"{w['name']}.json")
    return root


def spec_of(root: Path) -> dict:
    return harness.load_json(root / "BENCHMARK.json")
