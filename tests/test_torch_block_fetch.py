"""The stage 1-2 block batch `kernels.standardize_runs` on the CPU.

Its plain route against the decode `ShardedMatrix.fetch_blocks_device`
ran before it was one call (the standardized rows gathered with
`kernels.standardize`, then masked past each run), bit for bit on both
layouts; what the wrapper refuses; that the CPU route launches and
counts nothing; that every launch count has its plain version; and that
the resident EigenSNP stages 1-2 log one block batch a fetch.  The kernel itself is held to the plain route on the card
(`tests/test_torch_cuda.py`).
"""

import numpy as np
import pytest
import torch

from genomic_pca_tpu_torch.ops import kernels as tk
from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix, pack_int8_rows
from genomic_pca_tpu_torch.utils import profiling

D, N = 300, 37  # an odd sample count: a partial last byte when packed
# Runs: interior, one ending on the last row, batch padding (length 0).
STARTS = np.array([5, 250, 17])
LENS = np.array([40, 50, 0])
BUCKET = 64  # longer than every run


def _container(layout: str) -> ShardedMatrix:
    rng = np.random.default_rng(24)
    g = rng.integers(0, 3, size=(D, N)).astype(np.int8)
    g[rng.random((D, N)) < 0.1] = -127
    mean = rng.uniform(0.2, 1.8, D).astype(np.float32)
    std = rng.uniform(0.3, 1.2, D).astype(np.float32)
    std[7] = 0.0  # inv_std 0: the row standardizes to 0
    if layout == "packed":
        return ShardedMatrix.from_packed_rows(pack_int8_rows(g), mean, std, N, "cpu")
    return ShardedMatrix.from_arrays(iter([g]), means=[mean], stds=[std], device="cpu")


def _chain(sm: ShardedMatrix, starts, lens, bucket: int) -> torch.Tensor:
    """The decode of the block batch as separate PyTorch operations."""
    starts_t = torch.as_tensor(np.where(lens > 0, starts, 0))
    lens_t = torch.as_tensor(lens)
    offs = torch.arange(bucket)
    rows = torch.clamp(starts_t[:, None] + offs, max=sm.d_pad - 1).reshape(-1)
    x = tk.standardize(sm.geno[rows], sm.mean[rows], sm.inv_std[rows], "f32")
    x = x.reshape(len(starts_t), bucket, sm.n_pad)
    in_run = offs[None, :] < lens_t[:, None]
    return torch.where(in_run[:, :, None], x, torch.zeros(()))


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_plain_route_is_the_operation_chain(layout):
    sm = _container(layout)
    ref = _chain(sm, STARTS, LENS, BUCKET)
    got = tk.standardize_runs(sm.geno, sm.mean, sm.inv_std, STARTS, LENS, BUCKET)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    np.testing.assert_array_equal(
        sm.fetch_blocks_device(STARTS, LENS, BUCKET).numpy(), ref.numpy())
    assert got.shape == (3, BUCKET, sm.n_pad)
    assert not got[:, :, N:].any()  # padded samples are missing
    assert not got[0, 2].any() and got[0, 3].any()  # row 7 (inv_std 0), row 8
    assert not got[0, 40:].any() and not got[1, 50:].any() and not got[2].any()
    cols = torch.tensor([0, 3, 36, 17])
    np.testing.assert_array_equal(
        sm.fetch_blocks_device(STARTS, LENS, BUCKET, cols).numpy(),
        ref[:, :, cols].numpy())


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_whole_bucket_runs(layout):
    """Runs that fill their bucket, the last one ending on the last row."""
    sm = _container(layout)
    starts, lens = np.array([0, 236]), np.array([64, 64])
    np.testing.assert_array_equal(
        tk.standardize_runs(sm.geno, sm.mean, sm.inv_std, starts, lens, 64).numpy(),
        _chain(sm, starts, lens, 64).numpy())


def _refusal(case: str):
    sm = _container("packed")
    args = [sm.geno, sm.mean, sm.inv_std, STARTS, LENS, BUCKET]
    if case == "longer_than_bucket":
        args[4] = np.array([65, 1, 0])
    elif case == "wrong_dtype":
        args[0] = sm.geno.to(torch.int16)
    elif case == "moment_shape":
        args[1] = sm.mean[:-1]
    elif case == "run_lengths":
        args[4] = LENS[:2]
    elif case == "past_last_row":
        args[3] = np.array([5, 251, 17])
    return args


@pytest.mark.parametrize("case,error,match", [
    ("longer_than_bucket", ValueError, "longer than bucket"),
    ("wrong_dtype", TypeError, "uint8"),
    ("moment_shape", ValueError, "mean"),
    ("run_lengths", ValueError, "same length"),
    ("past_last_row", ValueError, "outside"),
])
def test_standardize_runs_refuses(case, error, match):
    with pytest.raises(error, match=match):
        tk.standardize_runs(*_refusal(case))


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_cpu_route_launches_and_counts_nothing(layout):
    sm = _container(layout)
    tk.reset_launch_counts()
    profiling.reset_counts()
    sm.fetch_blocks_device(STARTS, LENS, BUCKET)
    tk.standardize_runs(sm.geno, sm.mean, sm.inv_std, STARTS, LENS, BUCKET)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    assert "block_fetch_kernel" not in profiling.COUNTS


def test_plain_versions_cover_every_launch_count():
    """Each launch count, the block batch's of both layouts too, has the
    plain version the card's kernel is held to."""
    assert set(tk.PLAIN) == set(tk.LAUNCHES)
    assert tk.PLAIN["standardize_runs_i8"] is tk.standardize_runs_plain


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_resident_stages12_log_one_block_batch_a_fetch(tmp_path, caplog, monkeypatch,
                                                      layout):
    """The resident EigenSNP stages 1-2 log the block batches they slice,
    one `fetch_blocks_device` call each (on the card one launch each)."""
    from genomic_pca_tpu_torch.config import DataPrepConfig, EigenSnpConfig
    from genomic_pca_tpu_torch.io.bed import write_plink
    from genomic_pca_tpu_torch.models.eigensnp import compute_eigensnp_pca
    from genomic_pca_tpu_torch.models.prepare import prepare_data

    rng = np.random.default_rng(26)
    g = rng.integers(0, 3, size=(400, 48)).astype(np.int8)
    write_plink(tmp_path / "b", g, bp=list(range(10, 4010, 10)))
    # Six blocks of 40-100 SNPs: two row buckets' worth of batches.
    edges = [0, 400, 1400, 1800, 2400, 3400, 4010]
    (tmp_path / "blocks.tsv").write_text("".join(
        f"1 {lo + 1} {hi}\n" for lo, hi in zip(edges[:-1], edges[1:])))
    prep = prepare_data(DataPrepConfig(
        bed_path=str(tmp_path / "b"), ld_block_path=str(tmp_path / "blocks.tsv"),
        min_maf=0.0, max_hwe_p=1.0, packed_pipeline=layout == "packed"), device="cpu")
    calls = []
    fetch = ShardedMatrix.fetch_blocks_device
    monkeypatch.setattr(ShardedMatrix, "fetch_blocks_device",
                        lambda self, *a, **kw: calls.append(a) or fetch(self, *a, **kw))
    with caplog.at_level("INFO", logger="genomic_pca_tpu_torch"):
        compute_eigensnp_pca(prep, EigenSnpConfig(k_global=3, min_subset_size=10),
                             device="cpu")
    logged = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("EigenSNP stages 1-2: ")]
    assert logged == [f"EigenSNP stages 1-2: {len(calls)} block batches over this "
                      "rank's 6 blocks."]
    assert len(calls) >= 2
