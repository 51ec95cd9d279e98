"""Tiny cells end to end on the CPU through the program's plain paths,
past the harness's look for a chip: sound runs come out correct, and a
run with the timed path broken underneath comes out not correct, once
for each fault a cell can have; on both of the judge's paths, the
float64 Gram and, with the judge's sample threshold put below the tiny
cohort, the subspace iteration that judges a biobank's width."""

import copy
import json
import shutil
import tempfile

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import pca
from benchmark.tests import tiny

SEED = 2**31 + 101
ONE_CHIP = tiny.one_chip()
# The judge's paths: as the tiny cohort's 260 samples take it (the
# Gram), and "wide", with pca.GRAM_MAX_SAMPLES below them and blocks of
# about 1,000 rows, as a cohort of hundreds of thousands takes it.
JUDGES = ("gram", "wide")
WIDE_MAX_SAMPLES = 128
WIDE_BLOCK_ELEMS = 1 << 18


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("bench"))


def set_judge(monkeypatch, judge):
    if judge == "wide":
        monkeypatch.setattr(pca, "GRAM_MAX_SAMPLES", WIDE_MAX_SAMPLES)
        monkeypatch.setattr(pca, "BLOCK_ELEMS", WIDE_BLOCK_ELEMS)


def run(root, cell, trace=False, seconds=0.5):
    with tempfile.TemporaryDirectory() as tmp:
        return harness.run_cell(tiny.spec_of(root), cell, SEED, seconds, trace, "cpu",
                                tmp, 0.0, root=root)


# ---- faults of the timed path ------------------------------------------
def _sharded():
    from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix
    return ShardedMatrix


def unchanged(monkeypatch):
    """Every power pass returns its input: the state never moves."""
    sm = _sharded()
    monkeypatch.setattr(sm, "_gram", lambda self, bp: bp)
    monkeypatch.setattr(sm, "_gram_q8", lambda self, bp: bp)


def half_rows(monkeypatch):
    """Every reduction over the rows reads the first half of them and
    doubles the sum: the mean taken over the rest."""
    sm = _sharded()
    for name in ("_gram", "_gram_q8", "_tsq"):
        orig = getattr(sm, name)

        def halved(self, bp, orig=orig):
            h = max(1, self.d_pad // 2)
            view = copy.copy(self)
            view.geno, view.mean = self.geno[:h], self.mean[:h]
            view.inv_std, view._u = self.inv_std[:h], self._u[:h]
            return 2.0 * orig(view, bp)
        monkeypatch.setattr(sm, name, halved)


def altered(monkeypatch):
    """The answer altered where it is produced: the first eigenvalue 2%
    high and noise on the first score column."""
    from genomic_pca_tpu_torch.models import eigensnp, pca

    def wrap(fn):
        def bad(*a, **kw):
            res = fn(*a, **kw)
            res.eigenvalues = res.eigenvalues.copy()
            res.eigenvalues[0] *= 1.02
            s = res.scores.copy()
            noise = np.random.default_rng(0).standard_normal(s.shape[0])
            s[:, 0] += 0.2 * s[:, 0].std() * noise
            res.scores = s
            return res
        return bad
    monkeypatch.setattr(pca, "streamed_pca", wrap(pca.streamed_pca))
    monkeypatch.setattr(eigensnp, "compute_eigensnp_pca",
                        wrap(eigensnp.compute_eigensnp_pca))


def _wrap_results(monkeypatch, change):
    """`change(res)` applied to every PCA result where it is produced."""
    from genomic_pca_tpu_torch.models import eigensnp, pca

    def wrap(fn):
        def bad(*a, **kw):
            res = fn(*a, **kw)
            change(res)
            return res
        return bad
    monkeypatch.setattr(pca, "streamed_pca", wrap(pca.streamed_pca))
    monkeypatch.setattr(eigensnp, "compute_eigensnp_pca",
                        wrap(eigensnp.compute_eigensnp_pca))


def tail_column(monkeypatch):
    """The last PC, past the compared prefix, dropped: its score column
    (and loadings column) zero, as a column lost past a lane boundary."""
    def change(res):
        res.scores = res.scores.copy()
        res.scores[:, -1] = 0.0
        if res.loadings is not None:
            res.loadings = res.loadings.copy()
            res.loadings[:, -1] = 0.0
    _wrap_results(monkeypatch, change)


def tail_order(monkeypatch):
    """The eigenvalues of the second half of the k PCs, past the compared
    prefix, in ascending order: a Rayleigh-Ritz order gone wrong there."""
    def change(res):
        ev = res.eigenvalues.copy()
        h = len(ev) // 2
        ev[h:] = ev[h:][::-1]
        res.eigenvalues = ev
    _wrap_results(monkeypatch, change)


FAULTS = {"unchanged": unchanged, "half_rows": half_rows, "altered": altered,
          "tail_column": tail_column, "tail_order": tail_order}
TAIL_FAULTS = ("tail_column", "tail_order")


@pytest.mark.parametrize("judge", JUDGES)
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_sound_run_is_correct(root, cell, judge, monkeypatch):
    set_judge(monkeypatch, judge)
    res = run(root, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in harness.metrics_of(tiny.spec_of(root), cell,
                                                    "end_to_end")}
    assert set(res["metrics"]) == names
    for m in res["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("judge", JUDGES)
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_fault_is_not_correct(root, cell, fault, judge, monkeypatch):
    set_judge(monkeypatch, judge)
    FAULTS[fault](monkeypatch)
    res = run(root, cell)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1
    if fault in TAIL_FAULTS:
        # Past the compared prefix: only the check over all k sees it.
        checks = res["checks"]
        assert checks["pc_err"]["value"] <= checks["pc_err"]["limit"], checks
        assert checks["ritz_err"]["value"] > checks["ritz_err"]["limit"], checks


def test_traced_run_reads_its_layers(root):
    res = run(root, "kgp3_chr22-eigensnp", trace=True)
    assert res["correct"]
    got = set(res["metrics"])
    # On the CPU the trace holds no device operation: the device readers
    # find nothing and the host and span readers read their layers.
    assert {"qc_s", "load_s", "stages12_s", "global_refine_s"} <= got
    assert "device_idle.workflow" not in got
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # The program's counters: every .bim and .fam row of a job, parsed
    # by the native pass or by the line loop.
    sizes = harness.load_cell(tiny.spec_of(root), "kgp3_chr22-eigensnp",
                              root).config["sizes"]
    rows = res["metrics"]["table_rows_native"]["value"] + \
        res["metrics"]["table_rows_loop"]["value"]
    assert rows == sizes["n_snps"] + sizes["n_samples"]


def test_traced_rfit_reads_the_span_readers(root):
    res = run(root, "kgp3_chr22-rfit", trace=True)
    assert res["correct"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert m["sketch_ms.pca"] > 0
    # On the CPU: no sync, no byte brought back, and no device time, so
    # neither the passes' device time nor their roofline share.
    assert m["host_syncs.pca"] == 0 and m["d2h_mb.pca"] == 0
    assert not {"pass_device_ms.pca", "kernel_roofline.pca", "core_device_ms.pca",
                "pass_roofline.pca", "device_idle.pca"} & set(m)


@pytest.mark.parametrize("judge", JUDGES)
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_control_is_not_correct(root, cell, judge, monkeypatch):
    """The control (the reference in the program's place, fp8 operands)
    at the tiny size reads above the tiny limits, the program below."""
    from benchmark import control

    set_judge(monkeypatch, judge)
    spec = tiny.spec_of(root)
    c = harness.load_cell(spec, cell, root)
    job = harness.load_module(harness.HERE / "jobs" / f"{c.traffic['job']}.py")
    with tempfile.TemporaryDirectory() as tmp:
        got = control.readings_for_seed(spec, c, job, SEED, 1, True, "cpu",
                                        tmp)
    assert any(got["control"][k] > lim for k, lim in c.limits.items()), got
    assert all(got["program"][k] <= lim for k, lim in c.limits.items()), got


@pytest.mark.parametrize("judge", JUDGES)
def test_eigensnp_judge_path(root, judge, monkeypatch):
    """At or below pca.GRAM_MAX_SAMPLES the EigenSNP judge takes the
    float64 Gram over REF_ROWS-row blocks; above it subspace iteration,
    float32, k + REF_EXTRA_COLS columns, REF_ITERS passes from the run's
    seed, over blocks of pca.BLOCK_ELEMS // N rows, its QC counts too."""
    set_judge(monkeypatch, judge)
    cell = harness.load_cell(tiny.spec_of(root), "kgp3_chr22-eigensnp", root)
    job = harness.load_module(harness.HERE / "jobs" / "eigensnp.py")
    monkeypatch.setattr(job, "REF_ROWS", 2500)
    calls, rows = [], []
    read_bed, gram, subspace = job._read_bed, pca.gram_pca, pca.subspace_pca

    def counted(state):
        for p in read_bed(state):
            rows.append(p.shape[0])
            yield p

    def gram_pca(blocks, *a, **kw):
        calls.append(("gram", {x.dtype for x in blocks()}, a, kw))
        return gram(blocks, *a, **kw)

    def subspace_pca(blocks, *a, **kw):
        calls.append(("subspace", {x.dtype for x in blocks()}, a, kw))
        return subspace(blocks, *a, **kw)

    monkeypatch.setattr(job, "_read_bed", counted)
    monkeypatch.setattr(pca, "gram_pca", gram_pca)
    monkeypatch.setattr(pca, "subspace_pca", subspace_pca)
    d, n = cell.config["sizes"]["n_snps"], cell.config["sizes"]["n_samples"]
    k = cell.config["eigensnp"]["k_global"]
    with tempfile.TemporaryDirectory() as tmp:
        ctx = harness.Context(config=cell.config, traffic=cell.traffic, seed=SEED,
                              device=torch.device("cpu"), tmpdir=tmp)
        _, _, _, v, ev, _ = job.reference(job.setup(ctx))
    per = 2500 if judge == "gram" else WIDE_BLOCK_ELEMS // n
    want = [min(per, d - lo) for lo in range(0, d, per)]
    assert len(want) > 1
    # The QC counts, the solver's look at the dtype, then each pass.
    passes = 1 if judge == "gram" else pca.REF_ITERS + 1
    assert rows == want * (2 + passes)
    [(kind, dtypes, args, kw)] = calls
    if judge == "gram":
        assert kind == "gram" and dtypes == {torch.float64}
        assert v.shape == (n, n)
    else:
        assert kind == "subspace" and dtypes == {torch.float32}
        assert args[:3] == (n, k + pca.REF_EXTRA_COLS, pca.REF_ITERS)
        assert args[3] == SEED and kw == {"rounding": None}
        assert v.shape == (n, k + pca.REF_EXTRA_COLS)
    assert ev[0] >= ev[k]


def test_a_cell_added_as_files_runs(tmp_path):
    """A configuration and a cell added as files only: a copy of
    kgp3_chr22 under a new name, its traffic, limits and tiny files, and
    entries added to BENCHMARK.json's lists, every existing file as it
    was; the tiny root finds them by name and the cell runs correct."""
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(harness.ROOT / "BENCHMARK.json", src / "BENCHMARK.json")
    for sub in ("configs", "traffic", "limits", "tests/tiny"):
        shutil.copytree(harness.ROOT / "benchmark" / sub, src / "benchmark" / sub)
    before = {p: p.read_bytes() for p in src.rglob("*.json")}
    spec = tiny.spec_of(src)
    old, new, cell = "kgp3_chr22", "kgp3_copy", "kgp3_copy-eigensnp_copy"
    bench = src / "benchmark"

    def add(path, data):
        assert not path.exists()
        path.write_text(json.dumps(data))

    conf = dict(next(c for c in spec["configs"] if c["name"] == old),
                name=new, file=f"benchmark/configs/{new}.json")
    add(bench / "configs" / f"{new}.json",
        dict(harness.load_json(bench / "configs" / f"{old}.json"), name=new))
    add(bench / "traffic" / "eigensnp_copy.json",
        harness.load_json(bench / "traffic" / "eigensnp.json"))
    add(bench / "limits" / f"{cell}.json",
        harness.load_json(bench / "limits" / f"{old}-eigensnp.json"))
    add(bench / "tests" / "tiny" / f"{new}.json",
        harness.load_json(bench / "tests" / "tiny" / f"{old}.json"))
    add(bench / "tests" / "tiny" / "limits" / f"{cell}.json",
        harness.load_json(bench / "tests" / "tiny" / "limits" / f"{old}-eigensnp.json"))
    grown = copy.deepcopy(spec)
    grown["configs"].append(conf)
    grown["workloads"].append({"name": cell, "config": new, "traffic": "eigensnp_copy",
                               "chips": 1, "why": "a copy of kgp3_chr22-eigensnp"})
    for m in grown["end_to_end"] + grown["per_layer"]:
        if f"{old}-eigensnp" in m.get("workloads", []):
            m["workloads"].append(cell)
    (src / "BENCHMARK.json").write_text(json.dumps(grown))
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
    # Every entry BENCHMARK.json had is there as it was, but for the
    # new cell in the metrics' lists.
    for group in ("configs", "workloads"):
        assert grown[group][:len(spec[group])] == spec[group]
    assert tiny.one_chip(grown) == tiny.one_chip(spec) + [cell]

    root = tiny.tiny_root(tmp_path / "tiny", src)
    assert harness.load_cell(tiny.spec_of(root), cell, root).config["sizes"] == \
        harness.load_cell(tiny.spec_of(root), f"{old}-eigensnp", root).config["sizes"]
    res = run(root, cell)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(harness.load_json(
        bench / "tests" / "tiny" / "limits" / f"{cell}.json"))
    names = {m["name"] for m in harness.metrics_of(grown, cell, "end_to_end")}
    assert set(res["metrics"]) == names == {"setup_s", "workflow_job_s"}
