"""The port's row layout over R ranks: row segments against the JAX
container (tests/test_segments.py's cases), `from_local_rows` and
`from_owned_units` (a rank that owns no row included) against one rank.

R = 2 and 4 ranks are spawned in a gloo process group on the CPU
(`genomic_pca_tpu_torch.eval.multichip.run_ranks`, a file rendezvous and
a timeout on every collective).  Tolerances as in
tests/test_torch_sharded.py and tests/test_segments.py.
"""

import numpy as np
import pytest
import torch

from genomic_pca_tpu.parallel import sharded as js
from genomic_pca_tpu.parallel.mesh import make_mesh
from genomic_pca_tpu_torch.eval.multichip import run_ranks
from genomic_pca_tpu_torch.parallel import sharded as ts
from tests import multirank_cases as mc
from tests.conftest import make_genotypes
from tests.test_segments import _segmented_matrix
from tests.test_torch_multirank_container import (
    PASSES, RANKS, TIMEOUT_S, _jax_passes, _spec_of,
)


# ---------------------------------------------------------------------------
# Row segments (tests/test_segments.py's cases).


@pytest.fixture(scope="module")
def seg_case():
    rng = np.random.default_rng(12345)
    geno = make_genotypes(rng, 200, 40, missing_rate=0.02)
    mesh = make_mesh()
    prefix = js.ShardedMatrix.from_arrays(iter([geno]), mesh=mesh, mode="xla",
                                          tile_d=64, kernel_precision="f32")
    seg = _segmented_matrix(geno, mesh, seg_break=120, rows_pp=512)
    b = rng.standard_normal((40, 6)).astype(np.float32)
    w = rng.standard_normal((200, 3)).astype(np.float32)
    spec = _spec_of(seg, 200, 40, b, w,
                    kw=dict(kernel_precision="f32", tile_d=64,
                            row_segments=seg.row_segments))
    return geno, prefix, seg, spec


def test_segment_translation_matches_reference(seg_case):
    _geno, _prefix, seg, spec = seg_case
    sm_t = mc.container(spec)  # one rank: the whole segmented matrix
    for starts, lens in [([0, 60, 130], [50, 60, 70]), ([0, 130], [0, 0]),
                         ([119, 120, 199], [1, 1, 1])]:
        np.testing.assert_array_equal(sm_t.translate_row_runs(starts, lens),
                                      seg.translate_row_runs(np.array(starts),
                                                             np.array(lens)))
    for runs in ([[0, 50], [60, 60], [130, 70]], [[100, 40]], [[0, 0], [130, 0]]):
        runs = np.array(runs)
        assert sm_t.runs_device_sliceable(runs) == seg.runs_device_sliceable(runs)
    with pytest.raises(ValueError):
        sm_t.translate_row_runs(np.array([100]), np.array([40]))
    arr = np.arange(1024 * 2, dtype=np.float32).reshape(1024, 2)
    np.testing.assert_array_equal(sm_t._trim_rows(arr), seg._trim_rows(arr))
    np.testing.assert_array_equal(sm_t._segments_or_default, seg._segments_or_default)


SEG_RUNS = np.array([[0, 50], [60, 60], [130, 70]])


@pytest.fixture(scope="module")
def seg_runs(seg_case):
    """{R: per-rank passes and block slices of the segmented matrix}."""
    spec = dict(seg_case[3], runs=SEG_RUNS, bucket=128)
    got = {r: run_ranks(mc.segments_worker, r, (spec,), timeout_s=TIMEOUT_S)
           for r in RANKS}
    got[1] = [mc.segments_worker(spec)]
    return got


@pytest.mark.parametrize("ranks", [1, *RANKS])
def test_segmented_passes_match_reference(seg_case, seg_runs, ranks):
    geno, prefix, seg, spec = seg_case
    ref = _jax_passes(seg, spec["b"], spec["w"])
    for out in seg_runs[ranks]:
        for name in PASSES:
            np.testing.assert_allclose(out[name], ref[name], rtol=1e-4, atol=1e-2,
                                       err_msg=name)
        assert out["count_missing"] == int((geno == -127).sum())


@pytest.mark.parametrize("ranks", [1, *RANKS])
def test_segmented_block_slices(seg_case, seg_runs, ranks):
    """Blocks inside one segment are sliced on the rank that holds them
    and equal the JAX prefix container's slices; a run across the
    segment boundary is refused."""
    _geno, prefix, _seg, spec = seg_case
    ref = np.asarray(prefix.fetch_blocks_device(SEG_RUNS[:, 0], SEG_RUNS[:, 1], 128))
    got = seg_runs[ranks]
    seen = set()
    for out in got:
        assert out["sliceable"]
        for j, b_idx in enumerate(out["mine"]):
            np.testing.assert_allclose(out["blocks"][j], ref[b_idx], rtol=1e-5,
                                       atol=1e-5)
            seen.add(int(b_idx))
    assert seen == {0, 1, 2}
    if ranks == 2:  # segment 0 lives on rank 0, segment 1 on rank 1
        assert list(got[0]["owner"]) == [0, 0, 1]
    bad = dict(spec, runs=np.array([[100, 40]]), bucket=128)
    assert not mc.segments_worker(bad)["sliceable"]


# ---------------------------------------------------------------------------
# The constructors.


def _packed_case(rng, d, n):
    g = make_genotypes(rng, d, n, missing_rate=0.02)
    mean, std = ts.host_moments(g)
    return g, mean, std


@pytest.fixture(scope="module")
def local_rows_runs():
    """from_local_rows at R ranks in both modes, one rank, and the JAX
    container, on one data set of 700 SNPs."""
    rng = np.random.default_rng(47)
    d, n = 700, 50
    g, mean, std = _packed_case(rng, d, n)
    packed = ts.pack_int8_rows(g)
    b = (rng.standard_normal((n, 5)) / np.sqrt(n)).astype(np.float32)
    w = rng.standard_normal((d, 2)).astype(np.float32)
    specs = [dict(packed=packed, mean=mean, std=std, n_samples=n, tile_d=128,
                  mode=mode, b=b, w=w) for mode in ("1d", "2d")]
    many = {r: run_ranks(mc.local_rows_list_worker, r, (specs,), timeout_s=TIMEOUT_S)
            for r in RANKS}
    sm_j = js.ShardedMatrix.from_packed_rows(packed, mean, std, n, mesh=make_mesh(),
                                             mode="xla", kernel_precision="f32")
    return {(r, spec["mode"]): ([per_rank[i] for per_rank in many[r]],
                                mc.local_rows_worker(spec))
            for r in RANKS for i, spec in enumerate(specs)}, _jax_passes(sm_j, b, w)


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("mode", ["1d", "2d"])
def test_from_local_rows_matches_one_rank(local_rows_runs, ranks, mode):
    """Each rank reads only its tile-aligned range; passes equal the
    one-rank container's and the JAX container's."""
    runs, ref = local_rows_runs
    many, one = runs[(ranks, mode)]
    d = 700
    per = -(-(-(-d // ranks)) // 128) * 128
    for r, got in enumerate(many):
        assert got["read"] == ([(r * per, min((r + 1) * per, d))]
                               if r * per < d else [])
        assert got["layout"][2] % 128 == 0  # ranks start on q8 tile boundaries
        for name in PASSES:
            np.testing.assert_allclose(got[name], one[name], rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got[name], ref[name], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("owner", [[0, 1, 0], [3, 1, 1, 0, 3]])
def test_from_owned_units_with_an_empty_rank(rng, owner):
    """Units placed on their owners (rank 2 of 4 owns none, and with
    [0, 1, 0] the ranks hold unequal totals): passes equal the one-rank
    container over the units in order; segments as the JAX layout rule
    gives them."""
    ranks = 2 if max(owner) < 2 else 4
    n = 45
    sizes = [60, 0, 130, 25, 41][: len(owner)]
    geno = [make_genotypes(rng, s, n, missing_rate=0.02) if s
            else np.zeros((0, n), np.int8) for s in sizes]
    units = []
    for g in geno:
        m, s = ts.host_moments(g)
        units.append((ts.pack_int8_rows(g), m, s))
    all_g = np.concatenate(geno)
    b = (rng.standard_normal((n, 4)) / np.sqrt(n)).astype(np.float32)
    w = rng.standard_normal((len(all_g), 2)).astype(np.float32)
    spec = dict(units=units, owner=owner, n_samples=n, tile_d=64, mode="1d", b=b,
                w=w)
    many = run_ranks(mc.owned_units_worker, ranks, (spec,), timeout_s=TIMEOUT_S)
    m_all, s_all = ts.host_moments(all_g)
    one = mc.passes(ts.ShardedMatrix.from_packed_rows(
        ts.pack_int8_rows(all_g), m_all, s_all, n, "cpu", kernel_precision="f32",
        mode="1d"), spec)
    totals = np.bincount(owner, weights=sizes, minlength=ranks)
    per = -(-int(totals.max()) // 64) * 64
    cursor = np.zeros(ranks, dtype=int)
    want = []
    for u, (o, cnt) in enumerate(zip(owner, sizes)):
        if cnt:
            want.append((o * per + cursor[o], sum(sizes[:u]), cnt))
            cursor[o] += cnt
    for got in many:
        np.testing.assert_array_equal(got["row_segments"], np.array(want))
        assert got["layout"][3] == per
        for name in PASSES:
            np.testing.assert_allclose(got[name], one[name], rtol=1e-4, atol=1e-4)
        assert got["count_missing"] == int((all_g == -127).sum())


def test_from_owned_units_refuses_a_foreign_unit():
    with pytest.raises(RuntimeError, match="supplied unit 0 it does not own"):
        run_ranks(mc.foreign_unit_worker, 2, timeout_s=TIMEOUT_S)
    with pytest.raises(ValueError, match="ranks"):
        ts.ShardedMatrix.from_owned_units([10], [3], {}, 8, "cpu", packed=True)


@pytest.mark.parametrize("packed", [True, False])
def test_from_owned_units_reads_a_unit_strip_by_strip(rng, packed):
    """A unit given as a reader is read in strips of `strip_rows` rows and
    gives the container its host rows give; a short read is refused."""
    n = 37
    geno = [make_genotypes(rng, s, n, missing_rate=0.02) for s in (70, 33)]
    units = {}
    for u, g in enumerate(geno):
        m, s = ts.host_moments(g)
        units[u] = (ts.pack_int8_rows(g) if packed else g, m, s)
    calls = []

    def reader(rows):
        def read(lo, hi):
            calls.append((lo, hi))
            return rows[lo:hi]
        return read

    args = ([70, 33], [0, 0])
    a = ts.ShardedMatrix.from_owned_units(*args, units, n, "cpu", tile_d=64,
                                          packed=packed)
    b = ts.ShardedMatrix.from_owned_units(
        *args, {u: (reader(g), m, s) for u, (g, m, s) in units.items()}, n,
        "cpu", tile_d=64, packed=packed, strip_rows=32)
    assert calls == [(0, 32), (32, 64), (64, 70), (0, 32), (32, 33)]
    for x, y in ((a.geno, b.geno), (a.mean, b.mean), (a.inv_std, b.inv_std)):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a.row_segments, b.row_segments)
    g0, m0, s0 = units[0]
    with pytest.raises(ValueError, match="gave 31 rows"):
        ts.ShardedMatrix.from_owned_units(
            [70], [0], {0: (lambda lo, hi: g0[lo:hi - 1], m0, s0)}, n, "cpu",
            packed=packed, strip_rows=32)


def test_one_rank_container_is_unchanged_without_a_group(rng):
    """Without a process group the container is the one-device container:
    from_local_rows pads to the tile and equals from_packed_rows."""
    g, mean, std = _packed_case(rng, 300, 40)
    packed = ts.pack_int8_rows(g)
    a = ts.ShardedMatrix.from_local_rows(lambda lo, hi: (packed[lo:hi], mean[lo:hi],
                                                         std[lo:hi]),
                                         300, 40, "cpu", tile_d=128, packed=True)
    b = ts.ShardedMatrix.from_packed_rows(packed, mean, std, 40, "cpu")
    assert (a.world, a.rank, a.d_pad, a.row_offset) == (1, 0, 384, 0)
    assert torch.equal(a.geno[:300], b.geno) and torch.equal(a.mean[:300], b.mean)
    assert bool((a.inv_std[300:] == 0).all())
    bb = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    np.testing.assert_array_equal(a.right_apply(bb), b.right_apply(bb))


def test_rank_owning_nothing_holds_one_inert_tile(rng):
    """A rank that owns no row holds one q8 tile of inert rows, launches
    the kernels every rank launches, and adds exact zeros to each merge."""
    g, mean, std = _packed_case(rng, 40, 30)
    b = (rng.standard_normal((30, 4)) / np.sqrt(30)).astype(np.float32)
    spec = dict(unit=(ts.pack_int8_rows(g), mean, std), n_samples=30, b=b)
    got = run_ranks(mc.empty_rank_worker, 3, (spec,), timeout_s=TIMEOUT_S)
    assert [out["d_pad"] for out in got] == [64, 64, 64]
    assert not got[0]["gram_zero"]
    assert all(out["gram_zero"] and out["q8_zero"] for out in got[1:])
    for out in got[1:]:
        np.testing.assert_array_equal(out["gram"], got[0]["gram"])


def test_whole_matrix_constructors_refused_under_several_ranks():
    with pytest.raises(RuntimeError, match="holds the whole matrix"):
        run_ranks(mc.whole_matrix_worker, 2, timeout_s=TIMEOUT_S)
