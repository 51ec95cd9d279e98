"""The port's workflows over R ranks on the CPU: distributed QC, per-rank
VCF file sharding, multi-rank EigenSNP, the collectives, and what stays
single-rank.

Ranks are spawned in a gloo process group
(`genomic_pca_tpu_torch.eval.multichip.run_ranks`: a file rendezvous, a
timeout on every collective).  QC is held bit for bit to the port on one
rank and to the JAX package's `prepare_data`; the workflows' PCs to a
float64 PCA by the separated-prefix rule (`multichip.hold_pcs`) and to
the port on one rank.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from genomic_pca_tpu.io.bed import read_bim
from genomic_pca_tpu.io.ldblocks import block_aligned_ranges as jax_ranges
from genomic_pca_tpu.io.ldblocks import parse_ld_block_file
from genomic_pca_tpu.models.prepare import prepare_data as jax_prepare
from genomic_pca_tpu_torch.config import DataPrepConfig
from genomic_pca_tpu_torch.eval import multichip
from genomic_pca_tpu_torch.eval.multichip import run_ranks
from genomic_pca_tpu_torch.models import prepare as tprep
from genomic_pca_tpu_torch.parallel import mesh
from tests import multirank_cases as mc
from tests.test_eigensnp import _setup

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 240


# ---------------------------------------------------------------------------
# The collectives.


@pytest.mark.parametrize("ranks", [2, 4])
def test_collectives(ranks):
    got = run_ranks(mc.collectives_worker, ranks, timeout_s=TIMEOUT_S)
    total = ranks * (ranks + 1) / 2
    for r, out in enumerate(got):
        assert (out["rank"], out["world"]) == (r, ranks)
        np.testing.assert_array_equal(out["summed"], np.full((2, 3), total))
        np.testing.assert_array_equal(out["rows"][:, 0],
                                      np.repeat(np.arange(ranks, dtype=np.float32), 2))
        np.testing.assert_array_equal(
            out["tree"]["i"], np.stack([np.arange(3) + 10 * q for q in range(ranks)]))
        assert out["tree"]["b"].dtype == np.bool_
        np.testing.assert_array_equal(out["tree"]["b"][:, 0],
                                      [q % 2 == 0 for q in range(ranks)])
        assert out["objs"] == [{"rank": q, "shape": (q, 2)} for q in range(ranks)]


def test_no_group_is_the_identity(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.initialize_distributed("cpu") is False
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    t = torch.arange(4.0)
    assert mesh.all_reduce_sum(t) is t and mesh.all_gather_rows(t) is t
    got = mesh.all_gather_numpy({"a": np.arange(3)})
    np.testing.assert_array_equal(got["a"], np.arange(3)[None])
    assert mesh.all_gather_object(5) == [5]
    assert mesh.rank_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("device,local,cards,want", [
    ("cpu", 4, 0, "gloo"), ("cuda", 2, 2, "nccl"), ("cuda", 1, 8, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cuda", 8, 4, "gloo"),
])
def test_backend_rule(monkeypatch, device, local, cards, want):
    """NCCL when every rank has a card of its own, gloo on the CPU and for
    ranks that share a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh.choose_backend(device, local) == want


def test_rank_failure_stops_the_group():
    """A rank that raises makes the launcher stop the others (which wait
    in a collective) and report that rank's error."""
    with pytest.raises(RuntimeError, match="does not own"):
        run_ranks(mc.foreign_unit_worker, 4, timeout_s=TIMEOUT_S)


# ---------------------------------------------------------------------------
# Distributed QC.


@pytest.fixture(scope="module")
def qc_fileset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dqc")
    _geno, prefix, cfg = _setup(tmp, np.random.default_rng(7), n_snps=1200,
                                n_samples=90, missing_rate=0.05, n_blocks=9)
    return prefix, cfg


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("keep_list", [False, True])
def test_distributed_qc_bit_identical(qc_fileset, tmp_path, ranks, keep_list):
    """keep / mean / std merged from per-rank scans equal one rank's scan
    and the JAX package's bit for bit; the ranges are the JAX ranges."""
    prefix, jcfg = qc_fileset
    keep_path = None
    if keep_list:
        keep_path = str(tmp_path / "keep.txt")
        Path(keep_path).write_text("".join(f"sample{i}\n" for i in range(0, 90, 3)))
    jcfg = dataclasses.replace(jcfg, sample_keep_path=keep_path)
    cfg = DataPrepConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(DataPrepConfig)})
    one = mc.prepare_worker(cfg)
    ref = jax_prepare(dataclasses.replace(jcfg, qc_mode="host"))
    many = run_ranks(mc.prepare_worker, ranks, (cfg,), timeout_s=TIMEOUT_S)
    bim = read_bim(prefix + ".bim")
    want = jax_ranges(bim.chrom, bim.bp, parse_ld_block_file(cfg.ld_block_path), ranks)
    for got in many:
        assert [tuple(r) for r in got["scan_ranges"]] == [tuple(r) for r in want]
        for key in ("pca", "mean", "std"):
            np.testing.assert_array_equal(got[key], one[key], err_msg=key)
        np.testing.assert_array_equal(got["pca"], ref.pca_snp_orig_indices)
        np.testing.assert_array_equal(got["mean"], ref.mean)
        np.testing.assert_array_equal(got["std"], ref.std)
        assert got["n_post_qc"] == one["n_post_qc"] == ref.n_snps_post_qc


def test_allgather_qc_without_group_is_the_scan():
    keep = np.array([True, False, True])
    got = tprep._allgather_qc(keep, np.arange(3.0), np.ones(3), [(0, 3)])
    np.testing.assert_array_equal(got[0], keep)
    assert got[1].dtype == np.float64


def test_streaming_refused_with_several_ranks(qc_fileset):
    """The host-streamed container, once refused under several ranks, runs
    on two: each rank streams its own strips (i mod 2) and every pass
    equals the one-rank container's at rtol 1e-4 / atol 1e-4."""
    _prefix, jcfg = qc_fileset
    cfg = DataPrepConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(DataPrepConfig)})
    one = mc.streaming_worker(cfg)
    many = run_ranks(mc.streaming_worker, 2, (cfg,), timeout_s=TIMEOUT_S)
    n_strips = len(one["own_strips"])
    assert [m["own_strips"] for m in many] == [list(range(r, n_strips, 2))
                                               for r in range(2)]
    for got in many:
        for key in ("gram", "tsq", "right", "tsq_project", "project",
                    "tsq_capture", "capture"):
            np.testing.assert_allclose(got[key], one[key], rtol=1e-4, atol=1e-4,
                                       err_msg=key)


# ---------------------------------------------------------------------------
# The workflows (eval/multichip.py's checks at small sizes).


def test_multichip_passes_two_ranks():
    """The harness's first check (`python -m
    genomic_pca_tpu_torch.eval.multichip`): every pass in both modes, q8
    and f32, at two ranks against one rank, the PCs against float64."""
    report = multichip.check_passes(2, "cpu", timeout_s=TIMEOUT_S)
    assert set(report) == {"1d_q8", "1d_f32", "2d_q8", "2d_f32"}
    assert all(rep["separated"] == 4 for rep in report.values())


def test_eigensnp_four_ranks_degenerate_owner(tmp_path):
    """Four ranks over four blocks whose last block QC drops entirely:
    the last rank owns no row and still joins every collective."""
    rep = multichip.check_eigensnp(4, "cpu", tmp_path, n_blocks=4,
                                   degenerate_tail=True, split_legs=False,
                                   timeout_s=TIMEOUT_S)
    assert rep["rank_rows"][-1] == 0 and min(rep["rank_rows"][:3]) > 0
    assert rep["n_pca_snps"] <= 3000
    assert rep["matrix_path"] == "device-resident"
    assert rep["min_abs_r_vs_one_rank"] > 0.999


def test_eigensnp_four_ranks_split_legs_and_empty_ranks(tmp_path):
    """Two blocks over four ranks: the block-aligned ranges leave two
    ranks empty; the stop-after legs resume through rank 0's checkpoints."""
    rep = multichip.check_eigensnp(4, "cpu", tmp_path, n_blocks=2,
                                   timeout_s=TIMEOUT_S)
    assert sorted(rep["rank_rows"])[:2] == [0, 0]
    assert rep["split"]["min_abs_r"] > 0.999


def test_checkpoint_presence_is_rank_zeros_view(tmp_path):
    """A checkpoint counts as present on every rank when rank 0 sees it,
    also on a rank that does not (one that looked before rank 0 wrote
    it), so that no rank resumes where rank 0 saves and waits."""
    dirs = [str(tmp_path / f"rank{r}") for r in range(2)]
    got = run_ranks(mc.checkpoint_view_worker, 2, (dirs,), timeout_s=TIMEOUT_S)
    assert [out["own"] for out in got] == [True, False]
    assert all(out["agreed"] and not out["absent"] for out in got)


def test_eigensnp_blocks_across_ranks_take_host_path(tmp_path):
    """One block over two ranks cannot be split on a block boundary: the
    block crosses the ranks and stages 1-2 read it through the host
    accessor."""
    rep = multichip.check_eigensnp(2, "cpu", tmp_path, n_blocks=1,
                                   split_legs=False, refine_passes=4,
                                   timeout_s=TIMEOUT_S)
    assert rep["matrix_path"] == "host-accessor"
    assert all(rows > 0 for rows in rep["rank_rows"])


def test_vcf_four_ranks_zero_file_owner(tmp_path):
    """Three VCF files over four ranks: rank 3 parses none."""
    rep = multichip.check_vcf(4, "cpu", tmp_path, n_files=3, timeout_s=TIMEOUT_S)
    assert rep["many"]["min_abs_r"] > 0.999


def test_vcf_sharded_parse_owns_round_robin(tmp_path):
    from genomic_pca_tpu_torch.workflows import load_vcf_directory_sharded

    geno = multichip.structured_genotypes(3, 40, 12, missing=0.0)
    multichip.write_vcf_dir(tmp_path / "vcf", geno, 5)
    for rank, files in ((0, {0, 3}), (1, {1, 4}), (2, {2})):
        names, n_files, blocks = load_vcf_directory_sharded(
            str(tmp_path / "vcf"), 0.0, rank, 3)
        assert n_files == 5 and len(names) == 12
        assert set(blocks) <= files


# ---------------------------------------------------------------------------
# What stays on one rank.


def test_projection_refused_with_several_ranks():
    with pytest.raises(RuntimeError, match="single-process operation"):
        run_ranks(mc.projection_worker, 2, (("b", "l", "m", "o"),),
                  timeout_s=TIMEOUT_S)


def test_cli_project_refused_under_several_ranks(tmp_path):
    env = dict(os.environ, WORLD_SIZE="2", RANK="0")
    proc = subprocess.run(
        [sys.executable, "-m", "genomic_pca_tpu_torch", "-o", str(tmp_path / "o"),
         "--project", "--bed-file", "x", "--project-loadings", "l",
         "--project-moments", "m"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1
    assert "single-process operation" in proc.stderr


def test_native_library_builds_from_cold_concurrently(tmp_path):
    """Two ranks starting cold build the native library at once: both
    builds succeed and the library in place is whole."""
    import ctypes

    out = tmp_path / "native"
    procs = [subprocess.Popen(
        ["make", "-C", str(REPO / "genomic_pca_tpu_torch" / "native"), f"OUT={out}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for _ in range(2)]
    for p in procs:
        p.communicate(timeout=300)
        assert p.returncode == 0
    lib = ctypes.CDLL(str(out / "libplinkio.so"))
    assert lib.plinkio_abi_version() > 0
    assert [f.name for f in out.iterdir()] == ["libplinkio.so"]
