"""The port's container over R ranks against the JAX container on the
8-device virtual mesh of tests/conftest.py (the row layout:
tests/test_torch_multirank_layout.py).

R = 2 and 4 ranks are spawned in a gloo process group on the CPU
(`genomic_pca_tpu_torch.eval.multichip.run_ranks`, a file rendezvous and
a timeout on every collective); each rank adopts its shard of the JAX
container's bytes (`from_reference_arrays`) and runs the plain versions
of the kernels.  Every pass is held to the JAX container (in `mode="xla"`
at f32) and to the port on one rank with the tolerances of
tests/test_torch_sharded.py; the q8 power loop to the JAX interpret-mode
kernels by per-PC |r|.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from genomic_pca_tpu.parallel import sharded as js
from genomic_pca_tpu.parallel.mesh import make_mesh
from genomic_pca_tpu_torch.eval.multichip import run_ranks
from genomic_pca_tpu_torch.parallel import sharded as ts
from tests import multirank_cases as mc
from tests.conftest import make_genotypes
from tests.torch_cases import abs_corr

TIMEOUT_S = 240
RANKS = (2, 4)
PASSES = ("gram", "tsq", "right", "left")


def _spec_of(sm_j, d, n, b, w, **extra):
    spec = dict(geno=np.asarray(sm_j.geno), mean=np.asarray(sm_j.mean),
                inv_std=np.asarray(sm_j.inv_std), n_rows=d, n_samples=n, b=b,
                w=w)
    spec.update(extra)
    return spec


def _jax_passes(sm_j, b, w):
    bj = jnp.asarray(b)
    return {"gram": np.asarray(sm_j.gram_apply(bj)),
            "tsq": np.asarray(sm_j.tsq_accumulate(bj)),
            "right": sm_j.right_apply(bj), "left": sm_j.left_apply(w),
            "count_missing": sm_j.count_missing()}


@pytest.fixture(scope="module")
def f32_runs():
    """{(layout, mode): (JAX passes, port one-rank passes, {R: per-rank
    passes})} on a JAX container over 8 devices in f32."""
    rng = np.random.default_rng(41)
    d, n = 900, 70
    g = make_genotypes(rng, d, n, missing_rate=0.03, n_pops=3, fst=0.2)
    mean, std = ts.host_moments(g)
    b = (rng.standard_normal((n, 9)) / np.sqrt(n)).astype(np.float32)
    w = rng.standard_normal((d, 3)).astype(np.float32)
    keys, specs, refs = [], [], {}
    for layout in ("packed", "dense"):
        if layout == "packed":
            sm_j = js.ShardedMatrix.from_packed_rows(
                js.pack_int8_rows(g), mean, std, n, mesh=make_mesh(), mode="xla",
                tile_d=32, kernel_precision="f32")
        else:
            sm_j = js.ShardedMatrix.from_arrays(
                iter([g]), means=[mean], stds=[std], mesh=make_mesh(), mode="xla",
                tile_d=32, kernel_precision="f32")
        refs[layout] = _jax_passes(sm_j, b, w)
        for mode in ("1d", "2d"):
            keys.append((layout, mode))
            specs.append(_spec_of(sm_j, d, n, b, w, kw=dict(
                kernel_precision="f32", mode=mode, tile_d=32)))
    many = {r: run_ranks(mc.reference_list_worker, r, (specs,),
                         timeout_s=TIMEOUT_S) for r in RANKS}
    return {key: (refs[key[0]], mc.reference_worker(spec),
                  {r: [per_rank[i] for per_rank in many[r]] for r in RANKS})
            for i, (key, spec) in enumerate(zip(keys, specs))}


@pytest.mark.parametrize("name", PASSES)
@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("mode", ["1d", "2d"])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_passes_match_reference_mesh(f32_runs, layout, mode, ranks, name):
    ref, one, many = f32_runs[(layout, mode)]
    for r, got in enumerate(many[ranks]):
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-4, atol=1e-4,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got[name], one[name], rtol=1e-4, atol=1e-4,
                                   err_msg=f"rank {r} vs one rank")


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_count_missing_and_layout(f32_runs, layout, ranks):
    ref, one, many = f32_runs[(layout, "1d")]
    for r, got in enumerate(many[ranks]):
        assert got["count_missing"] == ref["count_missing"] == one["count_missing"]
        rank, world, offset, d_pad = got["layout"]
        assert (rank, world, offset) == (r, ranks, r * d_pad)
        assert ranks * d_pad >= 900 and d_pad % 32 == 0


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("mode", ["1d", "2d"])
def test_one_all_reduce_per_pass(f32_runs, mode, ranks):
    """The gram pass merges with exactly one all-reduce of (n_pad, L)."""
    _, _, many = f32_runs[("packed", mode)]
    for got in many[ranks]:
        c = got["gram_collectives"]
        assert c["all_reduce"] == 1 and c["all_gather"] == 0
        assert c["all_reduce_bytes"] == 4 * 9 * ts.packed_cols(70) * 4


@pytest.fixture(scope="module")
def q8_runs():
    """The q8 power loop: JAX interpret-mode kernels over 8 devices, the
    port on one rank and on R ranks."""
    rng = np.random.default_rng(43)
    d, n = 1024, 70
    g = make_genotypes(rng, d, n, missing_rate=0.02, n_pops=4, fst=0.2)
    mean, std = ts.host_moments(g)
    sm_j = js.ShardedMatrix.from_packed_rows(
        js.pack_int8_rows(g), mean, std, n, mesh=make_mesh(),
        mode="pallas_interpret", tile_d=32, kernel_precision="q8")
    geno = np.asarray(sm_j.geno)
    q8_tile = js._q8_packed_tile_d(geno.shape[0] // 8, geno.shape[1], 128, 32)
    b0 = rng.standard_normal((n, 8)).astype(np.float32)
    b = (rng.standard_normal((n, 9)) / np.sqrt(n)).astype(np.float32)
    spec = _spec_of(sm_j, d, n, b, rng.standard_normal((d, 3)).astype(np.float32),
                    b0=b0, tolerances=(10.0, 0.0),
                    kw=dict(kernel_precision="q8", tile_d=q8_tile))
    ref = {"q": np.asarray(sm_j.power_iterate(jnp.asarray(b0), 4)),
           "pca_core": sm_j.pca_core(jnp.asarray(b0), 4, 3),
           "n_done": {tol: sm_j.power_iterate(jnp.asarray(b0), 6, tolerance=tol)[1]
                      for tol in (10.0, 0.0)}}
    one = mc.reference_worker(spec)
    many = {r: run_ranks(mc.reference_worker, r, (spec,), timeout_s=TIMEOUT_S)
            for r in RANKS}
    return ref, one, many


@pytest.mark.parametrize("ranks", RANKS)
def test_q8_power_loop_and_pca_core_match_reference_mesh(q8_runs, ranks):
    ref, one, many = q8_runs
    v_j, s_j, e_j, l_j = ref["pca_core"]
    for got in many[ranks]:
        for j in range(3):  # the separated prefix (3 = n_pops - 1)
            assert abs_corr(ref["q"][:, j], got["q"][:, j]) > 0.9999, j
            assert abs_corr(one["q"][:, j], got["q"][:, j]) > 0.9999, j
        v_t, s_t, e_t, l_t = got["pca_core"]
        np.testing.assert_allclose(s_t, np.asarray(s_j), rtol=5e-3)
        np.testing.assert_allclose(s_t, one["pca_core"][1], rtol=1e-4)
        assert l_t.shape == l_j.shape == (1024, 3)
        for j in range(3):
            assert abs_corr(np.asarray(v_j)[:, j], v_t[:, j]) > 0.9999, j
            assert abs_corr(l_j[:, j], l_t[:, j]) > 0.9999, j


@pytest.mark.parametrize("ranks", RANKS)
def test_tolerance_exit_in_lockstep(q8_runs, ranks):
    """tol = 10 exits after the second steering pass plus the polish
    pass, tol = 0 runs every pass: on every rank, as on one rank and in
    the JAX container."""
    ref, one, many = q8_runs
    assert ref["n_done"] == one["n_done"] == {10.0: 3, 0.0: 6}
    for got in many[ranks]:
        assert got["n_done"] == one["n_done"]
        np.testing.assert_array_equal(got["q"], many[ranks][0]["q"])
