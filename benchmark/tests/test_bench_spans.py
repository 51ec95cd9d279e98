"""`benchmark/spans.py` on a synthetic trace, the span readers, and the
span tool on the tiny CPU cells."""

import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from benchmark import harness, spans
from benchmark.tests import tiny
from benchmark.tests.test_bench_cpu_cell import SEED

CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def ev(name, start, end, device=CPU, id=0, thread=1, annotation=False):
    return SimpleNamespace(name=name, device_type=device, id=id, thread=thread,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


# A window of 100 us: a job's `gp.pca` holding a q8 pass and a CholQR2,
# four device operations matched to their launches by correlation id,
# the GPU-side copy of the pass's range (no work), and two host syncs,
# one of them after `gp.pca`.
EVENTS = [
    ev("bench.window", 0, 100),
    ev("gp.pca", 10, 90),
    ev("gp.pass.q8_pass", 20, 40),
    ev("gp.pca.orth", 50, 60),
    ev("cudaLaunchKernel", 25, 26, id=7),
    ev("cudaLaunchKernel", 55, 56, id=8),
    ev("cudaLaunchKernel", 70, 71, id=9),
    ev("cudaMemcpyAsync", 80, 81, id=10),
    ev("cudaStreamSynchronize", 81, 84),
    ev("cudaStreamSynchronize", 95, 96),
    ev("q8_left2d_mma_kernel", 30, 45, CUDA, id=7),
    ev("geqr2", 60, 62, CUDA, id=8),
    ev("elementwise", 72, 78, CUDA, id=9),
    ev("Memcpy DtoH", 82, 84, CUDA, id=10),
    ev("gp.pass.q8_pass", 30, 45, CUDA, id=7, annotation=True),
]


def test_idle_gaps_are_the_uncovered_window():
    gaps = spans.idle_gaps(EVENTS, 0, 100)
    np.testing.assert_array_equal(gaps, [[0, 30], [45, 60], [62, 72], [78, 82],
                                         [84, 100]])


def test_reduce_charges_the_innermost_span():
    got = spans.reduce(EVENTS, 0, 100, spans.idle_gaps(EVENTS, 0, 100))
    by = got["by_name"]
    assert set(by) == {"gp.pca", "gp.pass.q8_pass", "gp.pca.orth"}
    us = 1e-6
    expect = {
        # host: the ranges' lengths; device: the operations launched in
        # each range and in no range inside it; idle: gaps [10, 20),
        # [45, 50), [62, 72), [78, 82), [84, 90) for gp.pca, [20, 30) for
        # the pass, [50, 60) for CholQR2.
        "gp.pca": (1, 80, 6 + 2, 10 + 5 + 10 + 4 + 6, 1),
        "gp.pass.q8_pass": (1, 20, 15, 10, 0),
        "gp.pca.orth": (1, 10, 2, 10, 0),
    }
    for name, (count, host, device, idle, syncs) in expect.items():
        assert by[name]["count"] == count
        assert by[name]["syncs"] == syncs
        assert by[name]["host_s"] == pytest.approx(host * us)
        assert by[name]["device_s"] == pytest.approx(device * us)
        assert by[name]["idle_s"] == pytest.approx(idle * us)
    assert got["syncs"] == 1 and got["syncs_per_pca"] == [1, 1]
    assert got["idle_in_spans_s"] == pytest.approx(55 * us)


def test_reduce_clips_to_the_window_and_skips_unlaunched_work():
    events = EVENTS + [ev("orphan_kernel", 86, 88, CUDA, id=99)]
    got = spans.reduce(events, 15, 100, spans.idle_gaps(events, 15, 100))
    by = got["by_name"]
    assert by["gp.pca"]["host_s"] == pytest.approx(75e-6)
    assert by["gp.pca"]["device_s"] == pytest.approx(8e-6)
    # The orphan splits [84, 90) of gp.pca's idle time; [10, 15) is
    # before the window.
    assert by["gp.pca"]["idle_s"] == pytest.approx((5 + 5 + 10 + 4 + 2 + 2) * 1e-6)


def test_span_metrics_of_a_reduction():
    sp = spans.reduce(EVENTS, 0, 100, spans.idle_gaps(EVENTS, 0, 100))
    got = spans.span_metrics(sp, {"d2h_bytes": 4_000_000}, 2, 0.01)
    assert got["pass_device_ms.pca"] == pytest.approx(15e-3 / 2)
    assert got["kernel_roofline.pca"] == pytest.approx(100 * 0.01 / (15e-3 / 2))
    assert got["d2h_mb.pca"] == pytest.approx(2.0)
    assert got["host_syncs.pca"] == pytest.approx(0.5)
    assert "sketch_ms.pca" not in got and "open_s" not in got


@pytest.mark.parametrize("name", ["open_s", "qc_scan_s", "ld_map_s"])
def test_span_readers(name):
    mod = harness.load_module(harness.HERE / "metrics" / f"{name}.py")
    key = name[:-2]
    rec = [{"stage_seconds": {key: 0.5}}, {"stage_seconds": {key: 0.7}}]
    win = harness.Window(cell=None, setup_s=1.0, window_s=2.0, records=rec)
    assert mod.read(win) is None  # untraced
    win.trace = {"busy_s": 0.0}
    assert mod.read(win) == pytest.approx(0.6)
    # A program without the span (the parent of this reader) reads nothing.
    win.records = [{"stage_seconds": {"matrix_load": 0.1}}]
    assert mod.read(win) is None


def test_span_and_count_readers_read_the_window():
    """The per-layer readers of spans and counts read a traced window's
    `spans` and the window's counts, a job; untraced, the span readers
    read nothing and the counters still do."""
    sp = spans.reduce(EVENTS, 0, 100, spans.idle_gaps(EVENTS, 0, 100))
    cell = SimpleNamespace(config={"sizes": {"n_snps": 262_144, "n_samples": 2_048},
                                   "pca": {"k": 10, "n_oversamples": 118}},
                           traffic={"passes": [["q8_pass", 1]]})
    win = harness.Window(cell=cell, setup_s=1.0, window_s=2.0, records=[{}, {}],
                         trace={"spans": sp},
                         counts={"d2h_bytes": 4_000_000, "table_rows_native": 10,
                                 "table_rows_loop": 0})
    bound = 4 * 262_144 * 2_048 * 128 / 1979e12 * 1e3
    want = dict(spans.span_metrics(sp, win.counts, 2, bound),
                table_rows_native=5.0, table_rows_loop=0.0)
    def reader(name):
        return harness.load_module(harness.HERE / "metrics" / f"{name}.py")

    names = ["pass_device_ms.pca", "kernel_roofline.pca", "d2h_mb.pca",
             "host_syncs.pca", "table_rows_native", "table_rows_loop"]
    for name in names + ["sketch_ms.pca"]:
        assert reader(name).read(win) == want.get(name), name
    assert want["kernel_roofline.pca"] == pytest.approx(100 * bound / 7.5e-3)
    win.trace = None
    for name in names[:4]:
        assert reader(name).read(win) is None
    win.counts = {}
    assert reader("table_rows_loop").read(win) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("spans"))


def _traced(root, cell):
    with tempfile.TemporaryDirectory() as tmp:
        return spans.traced_run(tiny.spec_of(root), cell, SEED, 0.5, "cpu", tmp, 0.0,
                                root=root)


def test_tiny_eigensnp_reads_the_preparation_spans(root):
    res = _traced(root, "kgp3_chr22-eigensnp")
    assert res["correct"]
    assert {"open_s", "qc_scan_s", "ld_map_s", "qc_s"} <= set(res["metrics"])
    m = {k: v["value"] for k, v in res["metrics"].items()}
    # Inside the outside clock, up to the stage seconds' rounding to 1 ms.
    assert m["open_s"] + m["qc_scan_s"] + m["ld_map_s"] <= m["qc_s"] + 1.5e-3
    by = res["spans"]["by_name"]
    assert by["gp.prepare.ld_map"]["count"] == 2 * res["attempted"]
    for name in ("gp.prepare", "gp.eigensnp.load", "gp.eigensnp.refine"):
        assert by[name]["count"] == res["attempted"]
    assert set(res["span_metrics"]) >= {"open_s", "qc_scan_s", "ld_map_s"}


def test_tiny_rfit_reads_the_sketch_and_keeps_the_result_line(root):
    res = _traced(root, "kgp3_chr22-rfit")
    assert res["correct"]
    n = res["attempted"]
    assert res["span_metrics"]["sketch_ms.pca"] > 0
    by = res["spans"]["by_name"]
    assert {k: by[k]["count"] for k in by if k.startswith("gp.pass.")} == {
        "gp.pass.q8_pass": 3 * n, "gp.pass.exact_pass": n, "gp.pass.rr_gram": n,
        "gp.pass.loadings": n}
    # No device on the CPU: nothing launched, no bytes brought back; no
    # fileset opened, so no table row parsed.
    assert "pass_device_ms.pca" not in res["span_metrics"]
    assert res["counts"] == {"d2h_bytes": 0, "table_rows_native": 0,
                             "table_rows_loop": 0}
    # The result line of the traced run, its keys and its breakdown as
    # `benchmark.run` prints them, and three more.
    assert list(res)[:6] == ["correct", "attempted", "failed", "metrics", "device",
                             "breakdown"]
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device",
                        "breakdown", "checks", "spans", "counts", "span_metrics"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert not any(name.startswith("gp.") for name, _ in res["breakdown"]["device_ops"])
