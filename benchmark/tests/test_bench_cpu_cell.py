"""Tiny cells end to end on the CPU through the program's plain paths,
past the harness's look for a chip: sound runs come out correct, and a
run with the timed path broken underneath comes out not correct, once
for each fault a cell can have."""

import copy
import tempfile

import numpy as np
import pytest

from benchmark import harness
from benchmark.tests import tiny

SEED = 2**31 + 101
# Limits at the tiny sizes (the cells' own are set from chip readings).
TINY_LIMITS = {
    "kgp3_chr22-eigensnp": {"kept_mismatch": 0, "moment_err": 2.0**-23,
                            "pc_err": 0.05, "ritz_err": 0.008},
    "kgp3_chr22-rfit": {"pc_err": 0.01, "ritz_err": 0.005},
}
ONE_CHIP = ["kgp3_chr22-eigensnp", "kgp3_chr22-rfit"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("bench"), TINY_LIMITS)


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


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_sound_run_is_correct(root, cell):
    res = run(root, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in harness.metrics_of(tiny.spec_of(root), cell,
                                                    "end_to_end")}
    assert set(res["metrics"]) == names
    for m in res["metrics"].values():
        assert m["value"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ONE_CHIP)
def test_fault_is_not_correct(root, cell, fault, monkeypatch):
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


def test_control_is_not_correct(root):
    """The control (the reference in the program's place, fp8 operands)
    at the tiny size reads above the tiny limits, the program below."""
    from benchmark import control

    spec = tiny.spec_of(root)
    c = harness.load_cell(spec, "kgp3_chr22-rfit", root)
    job = harness.load_module(harness.HERE / "jobs" / f"{c.traffic['job']}.py")
    with tempfile.TemporaryDirectory() as tmp:
        got = control.readings_for_seed(spec, c, job, SEED, 1, True, "cpu",
                                        tmp)
    assert any(got["control"][k] > lim for k, lim in c.limits.items()), got
    assert all(got["program"][k] <= lim for k, lim in c.limits.items()), got
