"""refine_roofline.workflow's least time against hand arithmetic, and its
reader on windows that have nothing to read."""

import pytest

from benchmark import harness
from benchmark.tests import tiny

READER = harness.load_module(harness.HERE / "metrics" / "refine_roofline.workflow.py")
UKB = harness.load_json(harness.ROOT / "benchmark" / "configs" / "ukb_pca.json")


def test_refine_work_least_time_at_ukb_width():
    # 2 q8 passes, 2 exact passes, the Rayleigh-Ritz Gram and the loadings
    # at 407,219 samples, ell 128, k 10, over d kept rows: the q8 and
    # exact passes 4 d n ell operations at 1,979 and 989 T/s, the Gram
    # 2 d n ell + 2 d ell^2 at 989, the loadings bound by their bytes.
    d, n, ell, k = 15_000, 407_219, 128, 10
    nb = d * (-(-n // 4))
    q8 = max(4 * d * n * ell / 1979e12, (nb + 8 * n * ell) / 3.35e12)
    exact = max(4 * d * n * ell / 989e12, (nb + 8 * n * ell) / 3.35e12)
    rr = max((2 * d * n * ell + 2 * d * ell * ell) / 989e12,
             (nb + 4 * n * ell + 4 * ell * ell) / 3.35e12)
    load = max(2 * d * n * k / 989e12, (nb + 4 * n * k + 4 * d * k) / 3.35e12)
    assert load == (nb + 4 * n * k + 4 * d * k) / 3.35e12
    got = READER.least_ms(UKB, d)
    assert got == pytest.approx(1e3 * (2 * q8 + 2 * exact + rr + load), rel=1e-12)
    assert got == pytest.approx(11.5276, abs=5e-4)


def test_refine_work_is_the_configurations():
    """The refinement's passes: refine_passes power passes, the QC gate's
    bound on the missing share taking two of them exact
    (resolve_q8_polish), then the Rayleigh-Ritz Gram and the loadings."""
    from genomic_pca_tpu_torch.parallel.sharded import resolve_q8_polish

    work = dict(UKB["refine_work"]["passes"])
    polish = resolve_q8_polish(None, 1.0 - UKB["qc"]["min_call_rate"])
    assert work == {"q8_pass": UKB["eigensnp"]["refine_passes"] - polish,
                    "exact_pass": polish, "rr_gram": 1, "loadings": 1}
    assert UKB["refine_work"]["ell"] == 128


def _window(trace=None, records=({"kept": list(range(100))},), counts=None):
    cell = harness.load_cell(tiny.SPEC, "ukb_pca-eigensnp")
    return harness.Window(cell=cell, setup_s=1.0, window_s=1.0, records=list(records),
                          trace=trace, counts=counts or {})


def test_readers_read_nothing_where_nothing_was_recorded():
    """Untraced, or a program without the 2-D counter (the parent of the
    counter): no reading, and no error."""
    count = harness.load_module(harness.HERE / "metrics" / "passes_2d.workflow.py")
    ms = harness.load_module(harness.HERE / "metrics" / "refine_pass_ms.workflow.py")
    win = _window(counts={"d2h_bytes": 0})
    assert READER.read(win) is None and ms.read(win) is None
    assert count.read(win) is None
    assert count.read(_window(counts={"passes_2d": 12}, records=[{}, {}])) == 6


def test_reader_divides_the_least_time_by_the_pass_device_time():
    spans = {"by_name": {"gp.pass.q8_pass": {"count": 3, "host_s": 0.1, "device_s": 0.03,
                                             "idle_s": 0.0, "syncs": 0}},
             "syncs": 0, "syncs_per_pca": [], "idle_in_spans_s": 0.0}
    win = _window(trace={"spans": spans}, records=[{"kept": list(range(100))}] * 2)
    want = 100.0 * READER.least_ms(win.cell.config, 100) / 15.0
    assert READER.read(win) == pytest.approx(want, rel=1e-12)
