"""The host-streamed container and the QC capture over R ranks on the CPU.

R = 2 and 3 ranks are spawned in a gloo process group
(`genomic_pca_tpu_torch.eval.multichip.run_ranks`: a file rendezvous, a
timeout on every collective).  Strip i runs on rank i mod R.  Every pass
of the port's `StreamingMatrix` (f32, packed and dense strips) is held at
rtol 1e-4 / atol 1e-4 to the JAX `StreamingMatrix` whose strips are dealt
over `jax.local_devices()[:R]` of the 8-device CPU mesh (mode "xla") and
to the port on one rank, with a strip count that is not a multiple of R
and with a rank that holds no strip; the q8 pass and the q8 power loop
(the tolerance exit in lockstep) to one rank.  The EigenSNP workflow with
`force_streaming=True` at two ranks is held to one rank (QC bit for bit,
per-PC |r| > 0.999 over the separated prefix), and the matrix each rank
gathers from its QC capture to the one it re-reads after the host scan,
bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from genomic_pca_tpu.ops.streaming import StreamingMatrix as JStreamingMatrix
from genomic_pca_tpu_torch.config import DataPrepConfig
from genomic_pca_tpu_torch.eval import multichip
from genomic_pca_tpu_torch.eval.multichip import run_ranks
from genomic_pca_tpu_torch.parallel import sharded as ts
from tests import multirank_cases as mc
from tests.conftest import make_genotypes
from tests.test_eigensnp import _setup
from tests.torch_cases import abs_corr

TIMEOUT_S = 240
PASSES = ("gram", "tsq", "right", "tsq_project", "project", "tsq_capture", "capture")
# (rows, strip rows): 5 strips (not a multiple of 2 or 3), and 2 strips
# (the third rank holds none).
SHAPES = ((300, 64), (100, 64))


def _spec(g, strip, packed, rng):
    d, n = g.shape
    mean, std = ts.host_moments(g)
    return dict(geno=ts.pack_int8_rows(g) if packed else g, mean=mean, std=std,
                strip=strip, n_rows=d, n_samples=n, packed=packed, tile_d=64,
                b=(rng.standard_normal((n, 7)) / np.sqrt(n)).astype(np.float32),
                b0=rng.standard_normal((n, 6)).astype(np.float32),
                w=rng.standard_normal((7, 3)).astype(np.float32))


def _jax_passes(spec, ranks):
    """The JAX container's passes over `ranks` CPU devices."""
    strip, d = spec["strip"], spec["n_rows"]

    def source(i):
        lo, hi = i * strip, min((i + 1) * strip, d)
        return spec["geno"][lo:hi], spec["mean"][lo:hi], spec["std"][lo:hi]

    sm = JStreamingMatrix(source, n_strips=-(-d // strip), n_rows=d,
                          n_samples=spec["n_samples"], strip_size=strip, mode="xla",
                          packed=spec["packed"], kernel_precision="f32",
                          devices=jax.local_devices()[:ranks])
    b = jnp.asarray(spec["b"])
    acc, project = sm.tsq_and_project(b)
    acc_c, ab = sm.tsq_and_capture(b)
    return {"gram": np.asarray(sm.gram_apply(b)), "tsq": np.asarray(sm.tsq_accumulate(b)),
            "right": sm.right_apply(b), "tsq_project": np.asarray(acc),
            "project": project(spec["w"]), "tsq_capture": np.asarray(acc_c),
            "capture": ab}


@pytest.fixture(scope="module")
def strip_runs():
    """{(packed, shape): (spec, one-rank outputs, {R: per-rank outputs})}."""
    rng = np.random.default_rng(51)
    keys, specs = [], []
    for packed in (True, False):
        for d, strip in SHAPES:
            g = make_genotypes(rng, d, 90, missing_rate=0.03, n_pops=3, fst=0.2)
            keys.append((packed, (d, strip)))
            specs.append(_spec(g, strip, packed, rng))
    one = mc.strips_worker(specs)
    many = {r: run_ranks(mc.strips_worker, r, (specs,), timeout_s=TIMEOUT_S)
            for r in (2, 3)}
    return {key: (specs[i], one[i], {r: [per[i] for per in many[r]] for r in many})
            for i, key in enumerate(keys)}


@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("packed", [True, False])
def test_streamed_passes_match_reference_devices(strip_runs, packed, shape, ranks):
    """Every pass on every rank against the JAX container over `ranks`
    devices and against one rank (rtol 1e-4, atol 1e-4); each rank
    streams strips rank, rank + R, ... and the rows come back in global
    order."""
    spec, one, many = strip_runs[(packed, shape)]
    ref = _jax_passes(spec, ranks)
    n_strips = -(-shape[0] // shape[1])
    for r, got in enumerate(many[ranks]):
        assert got["own_strips"] == list(range(r, n_strips, ranks))
        assert set(got["strips_seen"]) == {len(got["own_strips"])}
        for name in PASSES:
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-4, atol=1e-4,
                                       err_msg=name)
            np.testing.assert_allclose(got[name], one[name], rtol=1e-4, atol=1e-4,
                                       err_msg=name)
        assert got["right"].shape == (shape[0], 7)
        assert got["gram_collectives"]["all_reduce"] == 1


@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_streamed_q8_and_power_loop_in_lockstep(strip_runs, shape, ranks):
    """The q8 pass (out - ru folded per strip before the all-reduce)
    against one rank at rtol 1e-4 / atol 1e-4; the q8 power loop's basis
    the same on every rank and per-column |r| > 0.9999 against one rank
    over the leading two columns (n_pops - 1); tol = 10 exits after the
    second steering pass plus the polish, tol = 0 runs every pass, on
    every rank as on one."""
    spec, one, many = strip_runs[(True, shape)]
    assert one["n_done"] == {10.0: 3, 0.0: 6}
    for got in many[ranks]:
        np.testing.assert_allclose(got["q8"], one["q8"], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got["q"], many[ranks][0]["q"])
        assert got["n_done"] == one["n_done"]
        for j in range(2):
            assert abs_corr(got["q"][:, j], one["q"][:, j]) > 0.9999, j


def test_eigensnp_force_streaming_two_ranks(tmp_path):
    """`compute_eigensnp_pca(force_streaming=True)` at two ranks: the
    host-streamed container on both, stages 1-2 through the host accessor
    over each rank's scan range, QC bit for bit and the PCs held to one
    rank and to float64 (eval/multichip.py's rule)."""
    rep = multichip.check_eigensnp(2, "cpu", tmp_path, d=2000, n=150, n_blocks=8,
                                   split_legs=False, refine_passes=3,
                                   force_streaming=True, timeout_s=TIMEOUT_S)
    assert rep["container"] == "host-streamed"
    assert rep["matrix_path"] == "host-accessor"
    assert rep["min_abs_r_vs_one_rank"] > 0.999


def test_multichip_streamed_two_ranks():
    """The harness's streamed check (`python -m
    genomic_pca_tpu_torch.eval.multichip`): 7 strips over two ranks."""
    rep = multichip.check_streamed(2, "cpu", timeout_s=TIMEOUT_S)
    assert rep["strips"] == 7
    assert all(rep[tag]["min_abs_r_vs_one_rank"] > 0.999 for tag in ("f32", "q8"))


@pytest.fixture(scope="module")
def capture_runs(tmp_path_factory):
    """Two ranks: the capture and the re-read container of each config
    (packed, dense, a keep-list under the packed pipeline)."""
    tmp = tmp_path_factory.mktemp("mcap")
    _g, _prefix, jcfg = _setup(tmp, np.random.default_rng(8), n_snps=900,
                               n_samples=60, missing_rate=0.03, n_blocks=9)
    base = DataPrepConfig(**{f.name: getattr(jcfg, f.name)
                             for f in dataclasses.fields(DataPrepConfig)})
    base = dataclasses.replace(base, qc_device_batch=200)
    keep = tmp / "keep.txt"
    keep.write_text("".join(f"sample{i}\n" for i in range(0, 60, 3)))
    configs = {"packed": base,
               "dense": dataclasses.replace(base, packed_pipeline=False),
               "keep_list": dataclasses.replace(base, sample_keep_path=str(keep))}
    got = run_ranks(mc.capture_worker, 2, (list(configs.values()),),
                    timeout_s=TIMEOUT_S)
    return {name: [per[i] for per in got] for i, name in enumerate(configs)}


@pytest.mark.parametrize("name", ["packed", "dense", "keep_list"])
def test_multirank_capture_is_the_reread_unit(capture_runs, name):
    """On every rank the unit gathered from its own QC capture equals the
    unit it re-reads from the BED after the host scan, bit for bit:
    genotypes, moments, row count and row segments."""
    for out in capture_runs[name]:
        assert out["captured_device"] and not out["captured_host"]
        cap, ref = out["device"], out["host"]
        np.testing.assert_array_equal(cap["pca"], ref["pca"])
        assert cap["n_rows"] == ref["n_rows"]
        np.testing.assert_array_equal(cap["row_segments"], ref["row_segments"])
        for key in ("geno", "mean", "inv_std"):
            assert cap[key].dtype == ref[key].dtype
            np.testing.assert_array_equal(cap[key], ref[key], err_msg=key)
