"""A tiny copy of the benchmark's data files for CPU tests: each cell's
configuration with the sizes cut to a few thousand SNPs and a few
hundred samples, the traffic and limits as they are."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import harness

SIZES = {
    "kgp3_chr22": {"n_snps": 6000, "n_samples": 260},
}


def tiny_root(tmp: Path, limits=None) -> Path:
    """A root holding BENCHMARK.json and benchmark/{configs,traffic,
    limits} with tiny sizes; `limits` {cell: {number: limit}} overrides."""
    root = tmp / "root"
    src = harness.ROOT
    (root / "benchmark").mkdir(parents=True)
    shutil.copy(src / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("traffic", "limits", "configs"):
        shutil.copytree(src / "benchmark" / sub, root / "benchmark" / sub)
    for name, sizes in SIZES.items():
        p = root / "benchmark" / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg["sizes"] = sizes
        if "fileset" in cfg:
            cfg["fileset"]["ld_blocks"] = 6
        if "eigensnp" in cfg:
            cfg["eigensnp"]["min_subset_size"] = 100
        p.write_text(json.dumps(cfg))
    for cell, lims in (limits or {}).items():
        p = root / "benchmark" / "limits" / f"{cell}.json"
        p.write_text(json.dumps(lims))
    return root


def spec_of(root: Path) -> dict:
    return harness.load_json(root / "BENCHMARK.json")
