"""One seeded data set at R ranks and at one rank: the multi-rank check.

    python -m genomic_pca_tpu_torch.eval.multichip --ranks 2 [--device cpu]

The twin of the JAX package's `__graft_entry__.dryrun_multichip` and of
`scripts/validate_multiprocess_{cpu,vcf}.py`.  It spawns R ranks in one
`torch.distributed` process group (parallel/mesh.py; gloo on the CPU or
when the ranks share a device, NCCL when each has its own) and runs on
data made from `--seed`:

1. every pass of the container (`gram_apply`, `tsq_accumulate`,
   `right_apply`, `left_apply`, `count_missing`) in both modes, packed,
   built by `from_local_rows`, against the one-rank container;
   `streamed_pca` in q8 and f32, and `power_iterate` with a tolerance
   (the early exit must be the same on every rank);
2. the EigenSNP workflow (distributed QC, per-rank matrix units, stages
   1-2 on the blocks each rank holds) with a sample subset and with the
   stop-after split legs, against one rank: QC bit for bit;
3. the VCF workflow with per-rank file sharding (with R = 4 over three
   files, one rank parses none);
4. the host-streamed container over the ranks (strip i on rank i mod R,
   an odd strip count): every pass (`gram_apply`, the q8 pass,
   `tsq_accumulate`, `right_apply`, `tsq_and_project`, `_tsq_and_capture`)
   and `streamed_pca` in q8 and f32 with the tolerance exit, against the
   same container on one rank; then the EigenSNP workflow with
   `force_streaming=True` against one rank (QC bit for bit).

Every run holds all k PCs to the separated-prefix rule against a float64
PCA: per-PC |r| > 0.999 and eigenvalues within 1e-3 over the PCs
separated from both neighbours by a 5% eigengap, the principal cosines
of that subspace above 0.999, and no Ritz value above its eigenvalue by
more than 1e-3.  The last line of standard output is one JSON object;
the exit code is 0 only when every check passed.  `run_ranks` is the
launcher the tests use too.
"""

from __future__ import annotations

import argparse
import json
import logging
import multiprocessing as mp
import os
import queue
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from genomic_pca_tpu_torch.parallel import mesh
from genomic_pca_tpu_torch.parallel.sharded import host_moments

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# The launcher.


def _rank_entry(fn, rank, world, init_method, device, timeout_s, args,
                results) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    try:
        mesh.initialize_distributed(device, init_method=init_method, rank=rank,
                                    world_size=world, timeout_s=timeout_s)
        results.put((rank, True, fn(*args)))
    except BaseException:  # reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        mesh.shutdown()


def run_ranks(fn: Callable, world: int, args: tuple = (), device: str = "cpu",
              timeout_s: float = 300.0) -> list:
    """`fn(*args)` on `world` spawned ranks of one process group; returns
    the ranks' results in rank order.

    `fn` must be importable by path (a module-level function) and its
    result picklable.  The ranks meet through a file in a temporary
    directory (no port); every collective and the whole run are bounded
    by `timeout_s`.  A rank that raises makes the launcher stop the others
    and raise RuntimeError with that rank's traceback."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/pg"
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_entry,
                             args=(fn, r, world, init, device, timeout_s, args,
                                   results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got: Dict[int, object] = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world:
                wait = deadline - time.monotonic()
                if wait <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(got))} "
                                       f"did not finish within {timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(wait, 2.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and not p.is_alive()]
                    if dead:
                        raise RuntimeError(f"rank(s) {dead} exited without a "
                                           "result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
                got[rank] = payload
        finally:
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# Data and the float64 oracle.


def structured_genotypes(seed: int, d: int, n: int, n_pops: int = 5,
                         fst: float = 0.1, missing: float = 0.01) -> np.ndarray:
    """Balding-Nichols dosages (d, n) int8, -127 missing, populations of
    unequal size (so that the top PCs separate)."""
    rng = np.random.default_rng(seed)
    anc = rng.uniform(0.1, 0.9, size=d)
    freqs = rng.beta((anc * (1 - fst) / fst)[:, None],
                     ((1 - anc) * (1 - fst) / fst)[:, None], size=(d, n_pops))
    w = 0.6 ** np.arange(n_pops)
    pop_of = rng.choice(n_pops, size=n, p=w / w.sum())
    geno = rng.binomial(2, freqs[:, pop_of]).astype(np.int8)
    if missing > 0:
        geno[rng.random((d, n)) < missing] = -127
    return geno


def float64_pcs(geno: np.ndarray, mean, std, k: int, center_only: bool = False):
    """(eigvecs (n, k), the top k + 1 eigenvalues) of A^T A in float64,
    A = diag(1/std)(G - mean), missing -> 0."""
    valid = geno != -127
    x = np.where(valid, geno - np.asarray(mean, np.float64)[:, None], 0.0)
    if not center_only:
        s = np.asarray(std, np.float64)
        x *= np.where(s > 0, 1.0 / np.where(s > 0, s, 1.0), 0.0)[:, None]
    ev, vec = np.linalg.eigh(x.T @ x)
    return vec[:, ::-1][:, :k], ev[::-1][: k + 1]


def separated_prefix(evals, k: int) -> int:
    """Leading PCs each separated from both neighbours by a relative
    eigengap of at least 5% (`evals` holds k + 1 descending values)."""
    for j in range(k):
        if (evals[j] - evals[j + 1]) / max(evals[j], 1e-300) < 0.05:
            return j
    return k


def hold_pcs(scores, v_true, ev_true, got_ev, k: int, label: str) -> dict:
    """The separated-prefix rule over all k PCs (module docstring);
    raises AssertionError on a failure, returns the numbers."""
    sep = separated_prefix(ev_true, k)
    if sep < 1:
        raise AssertionError(f"{label}: no eigengap-separated PC to check")
    rs = [abs(float(np.corrcoef(scores[:, j], v_true[:, j])[0, 1]))
          for j in range(sep)]
    qf = np.linalg.qr(np.asarray(scores[:, :sep], np.float64))[0]
    qe = np.linalg.qr(v_true[:, :sep])[0]
    cos = float(np.linalg.svd(qf.T @ qe, compute_uv=False).min())
    got_ev = np.asarray(got_ev, np.float64)
    ev_rel = np.abs(got_ev[:sep] - ev_true[:sep]) / ev_true[:sep]
    ritz = (got_ev[:k] - ev_true[:k]) / ev_true[:k]
    out = {"separated": sep, "min_abs_r": min(rs), "min_cosine": cos,
           "max_eigenvalue_rel_err": float(ev_rel.max()),
           "max_ritz_excess": float(ritz.max())}
    if (min(rs) <= 0.999 or cos <= 0.999 or out["max_eigenvalue_rel_err"] > 1e-3
            or out["max_ritz_excess"] > 1e-3):
        raise AssertionError(f"{label}: PCs disagree with the float64 oracle: {out}")
    return out


def min_abs_r(a, b, cols: int) -> float:
    """Smallest per-column |r| of the first `cols` columns of a and b."""
    return min(abs(float(np.corrcoef(a[:, j], b[:, j])[0, 1])) for j in range(cols))


# ---------------------------------------------------------------------------
# Workers (one call per rank; module level, so the ranks can import them).


def passes_worker(spec: dict) -> dict:
    """Every pass of a container built by `from_local_rows` over the
    packed rows of `spec` (or over one rank: no process group)."""
    from genomic_pca_tpu_torch.models.pca import power_iterate, streamed_pca
    from genomic_pca_tpu_torch.ops import kernels
    from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix, pack_int8_rows

    dev = mesh.rank_device(spec["device"])
    geno = structured_genotypes(spec["seed"], spec["d"], spec["n"])
    mean, std = host_moments(geno)
    packed = pack_int8_rows(geno)
    b = np.random.default_rng(spec["seed"] + 1).standard_normal(
        (spec["n"], spec["ell"])).astype(np.float32) / np.sqrt(spec["n"])
    w = np.random.default_rng(spec["seed"] + 2).standard_normal(
        (spec["d"], 3)).astype(np.float32)
    out = {}
    for mode in ("1d", "2d"):
        for precision in ("q8", "f32"):
            tag = f"{mode}_{precision}"
            sm = ShardedMatrix.from_local_rows(
                lambda lo, hi: (packed[lo:hi], mean[lo:hi], std[lo:hi]),
                spec["d"], spec["n"], dev, tile_d=spec["tile_d"], packed=True,
                mode=mode, kernel_precision=precision)
            bt = torch.from_numpy(b).to(dev)
            out[f"gram_{tag}"] = sm.gram_apply(bt).cpu().numpy()
            out[f"tsq_{tag}"] = sm.tsq_accumulate(bt).cpu().numpy()
            out[f"right_{tag}"] = sm.right_apply(bt)
            out[f"left_{tag}"] = sm.left_apply(w)
            kernels.reset_launch_counts()
            res = streamed_pca(sm, k=spec["k"], n_power_iter=spec["n_iter"],
                               seed=spec["seed"], compute_loadings=True)
            out[f"launches_{tag}"] = dict(kernels.LAUNCHES)
            out[f"scores_{tag}"] = res.scores
            out[f"sigma_{tag}"] = res.singular_values
            out[f"loadings_{tag}"] = res.loadings
            _, n_done = power_iterate(sm, bt, 6, tolerance=spec["tolerance"])
            out[f"n_done_{tag}"] = n_done
    out["count_missing"] = sm.count_missing()
    return out


def streamed_worker(spec: dict) -> dict:
    """Every pass of a host-streamed container over the packed rows of
    `spec` in strips of `spec["strip"]` rows (strip i on rank i mod R),
    in f32 and q8, then `streamed_pca` and the tolerance exit."""
    from genomic_pca_tpu_torch.models.pca import power_iterate, streamed_pca
    from genomic_pca_tpu_torch.ops.streaming import StreamingMatrix
    from genomic_pca_tpu_torch.parallel.sharded import pack_int8_rows

    dev = mesh.rank_device(spec["device"])
    d, n, strip = spec["d"], spec["n"], spec["strip"]
    geno = structured_genotypes(spec["seed"], d, n)
    mean, std = host_moments(geno)
    packed = pack_int8_rows(geno)

    def source(i):
        lo, hi = i * strip, min((i + 1) * strip, d)
        return packed[lo:hi], mean[lo:hi], std[lo:hi]

    b = torch.from_numpy(np.random.default_rng(spec["seed"] + 1).standard_normal(
        (n, spec["ell"])).astype(np.float32) / np.sqrt(n)).to(dev)
    w = np.random.default_rng(spec["seed"] + 2).standard_normal(
        (spec["ell"], 3)).astype(np.float32)
    out = {}
    for precision in ("f32", "q8"):
        sm = StreamingMatrix(source, -(-d // strip), d, n, strip, packed=True,
                             device=dev, mode="1d", kernel_precision=precision,
                             tile_d=spec["tile_d"])
        if precision == "f32":
            out["gram"] = sm.gram_apply(b).cpu().numpy()
            out["tsq"] = sm.tsq_accumulate(b).cpu().numpy()
            out["right"] = sm.right_apply(b)
            acc, project = sm.tsq_and_project(b)
            out["tsq_project"], out["project"] = acc.cpu().numpy(), project(w)
            acc, ab = sm._tsq_and_capture(b)
            out["tsq_capture"], out["capture"] = acc.cpu().numpy(), ab
        else:
            out["q8"] = sm.q8_pass(b).cpu().numpy()
        res = streamed_pca(sm, k=spec["k"], n_power_iter=spec["n_iter"],
                           seed=spec["seed"], compute_loadings=True)
        out[f"scores_{precision}"] = res.scores
        out[f"sigma_{precision}"] = res.singular_values
        out[f"loadings_{precision}"] = res.loadings
        out[f"n_done_{precision}"] = power_iterate(sm, b, 6, tolerance=spec["tolerance"])[1]
        out["own_strips"] = sm.own_strips
    return out


def eigensnp_worker(spec: dict) -> dict:
    """`prepare_data` and `compute_eigensnp_pca` on the fileset of `spec`
    (with `force_streaming` from `spec`), once whole and once in
    stop-after legs (stage1_bases, stage2_basis, then the rest) through a
    checkpoint directory."""
    import dataclasses

    from genomic_pca_tpu_torch.config import DataPrepConfig, EigenSnpConfig
    from genomic_pca_tpu_torch.models.eigensnp import compute_eigensnp_pca
    from genomic_pca_tpu_torch.models.prepare import prepare_data

    dev = mesh.rank_device(spec["device"])
    prep = prepare_data(DataPrepConfig(**spec["prep"]), device=dev)
    cfg = EigenSnpConfig(**spec["algo"])
    streamed = spec.get("force_streaming", False)
    res = compute_eigensnp_pca(prep, cfg, device=dev, force_streaming=streamed)
    out = {"keep": prep.pca_snp_orig_indices, "mean": prep.mean, "std": prep.std,
           "scores": res.scores, "eigenvalues": res.eigenvalues,
           "scan_ranges": prep.scan_ranges, "container": res.container}
    if spec.get("checkpoint_dir"):
        for leg in ("stage1_bases", "stage2_basis"):
            assert compute_eigensnp_pca(prep, cfg, device=dev,
                                        checkpoint_dir=spec["checkpoint_dir"],
                                        stop_after_checkpoint=leg) is None
        split = compute_eigensnp_pca(prep, cfg, device=dev,
                                     checkpoint_dir=spec["checkpoint_dir"])
        out["split_scores"] = split.scores
        out["split_eigenvalues"] = split.eigenvalues
    if spec.get("diagnostics"):
        diag = compute_eigensnp_pca(
            prep, dataclasses.replace(cfg, collect_diagnostics=True),
            device=dev, force_streaming=streamed).diagnostics
        out["matrix_path"] = diag["matrix_path"]
    return out


def vcf_worker(spec: dict) -> None:
    """`run_vcf_workflow` on the directory of `spec`."""
    from genomic_pca_tpu_torch.workflows import run_vcf_workflow

    run_vcf_workflow(spec["vcf_dir"], spec["prefix"], k=spec["k"], maf=0.01,
                     rfit_seed=5, device=mesh.rank_device(spec["device"]))


# ---------------------------------------------------------------------------
# Fixtures written to disk.


def write_fileset(prefix: Path, geno: np.ndarray, n_blocks: int) -> str:
    """PLINK fileset of `geno` (SNP i at chr 1, position 10 (i + 1)) and a
    block file of `n_blocks` equal intervals; returns the block file."""
    from genomic_pca_tpu_torch.io.bed import write_plink

    d = geno.shape[0]
    write_plink(prefix, geno, bp=[10 * (i + 1) for i in range(d)])
    per = 10 * d // n_blocks
    path = f"{prefix}.blocks.tsv"
    with open(path, "w") as fh:
        fh.write("".join(f"1 {b * per + 1} {(b + 1) * per}\n" for b in range(n_blocks)))
    return path


def write_vcf_dir(path: Path, geno: np.ndarray, n_files: int) -> None:
    """GT-only VCF files of (V, N) dosages 0/1/2, split into `n_files`."""
    path.mkdir(parents=True, exist_ok=True)
    v, n = geno.shape
    tok = np.array(["0/0", "0/1", "1/1"])
    head = ("##fileformat=VCFv4.2\n"
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\t"
            "FORMAT\t" + "\t".join(f"S{i:04d}" for i in range(n)) + "\n")
    per = -(-v // n_files)
    for f in range(n_files):
        with open(path / f"chr{f + 1:02d}.vcf", "w") as fh:
            fh.write(head)
            for i in range(f * per, min((f + 1) * per, v)):
                fh.write(f"{f + 1}\t{100 + 10 * i}\t.\tA\tC\t.\tPASS\t.\tGT\t"
                         + "\t".join(tok[geno[i]]) + "\n")


# ---------------------------------------------------------------------------
# The checks.


def check_passes(ranks: int, device: str, d: int = 3000, n: int = 160,
                 seed: int = 11, n_iter: int = 6, timeout_s: float = 600) -> dict:
    spec = dict(seed=seed, d=d, n=n, ell=12, k=4, n_iter=n_iter, tile_d=256,
                tolerance=1e-3, device=device)
    one = passes_worker(spec)
    many = run_ranks(passes_worker, ranks, (spec,), device=device,
                     timeout_s=timeout_s)
    geno = structured_genotypes(seed, d, n)
    mean, std = host_moments(geno)
    v_true, ev_true = float64_pcs(geno, mean, std, spec["k"])
    report = {}
    for key in one:
        if key.split("_")[0] in ("gram", "tsq", "right", "left"):
            for r in range(ranks):
                np.testing.assert_allclose(many[r][key], one[key], rtol=1e-4,
                                           atol=1e-4, err_msg=key)
    for tag in ("1d_q8", "1d_f32", "2d_q8", "2d_f32"):
        for r in range(ranks):
            if many[r][f"n_done_{tag}"] != many[0][f"n_done_{tag}"]:
                raise AssertionError(f"{tag}: ranks exit the power loop at "
                                     "different steps")
            np.testing.assert_array_equal(many[r][f"scores_{tag}"],
                                          many[0][f"scores_{tag}"])
        report[tag] = hold_pcs(many[0][f"scores_{tag}"], v_true, ev_true,
                               many[0][f"sigma_{tag}"].astype(np.float64) ** 2,
                               spec["k"], f"passes {tag} x{ranks}")
    if any(m["count_missing"] != one["count_missing"] for m in many):
        raise AssertionError("count_missing differs from one rank")
    return report


def check_streamed(ranks: int, device: str, d: int = 3000, n: int = 160,
                   strip: int = 448, seed: int = 11, timeout_s: float = 600) -> dict:
    """The host-streamed container at `ranks` ranks against one rank: the
    passes at rtol 1e-4 / atol 1e-4, the power loop's exit and the scores
    the same on every rank, the PCs against float64."""
    spec = dict(seed=seed, d=d, n=n, strip=strip, ell=12, k=4, n_iter=6,
                tile_d=128, tolerance=1e-3, device=device)
    one = streamed_worker(spec)
    many = run_ranks(streamed_worker, ranks, (spec,), device=device,
                     timeout_s=timeout_s)
    geno = structured_genotypes(seed, d, n)
    mean, std = host_moments(geno)
    v_true, ev_true = float64_pcs(geno, mean, std, spec["k"])
    n_strips = -(-d // strip)
    if sorted(i for m in many for i in m["own_strips"]) != list(range(n_strips)):
        raise AssertionError("the ranks do not hold every strip once")
    for key in ("gram", "q8", "tsq", "right", "tsq_project", "project",
                "tsq_capture", "capture"):
        for r in range(ranks):
            np.testing.assert_allclose(many[r][key], one[key], rtol=1e-4,
                                       atol=1e-4, err_msg=key)
    report = {"strips": n_strips}
    for tag in ("f32", "q8"):
        for m in many:
            if m[f"n_done_{tag}"] != one[f"n_done_{tag}"]:
                raise AssertionError(f"streamed {tag}: the power loop exits at "
                                     "another pass than on one rank")
            np.testing.assert_array_equal(m[f"scores_{tag}"], many[0][f"scores_{tag}"])
        report[tag] = hold_pcs(many[0][f"scores_{tag}"], v_true, ev_true,
                               many[0][f"sigma_{tag}"].astype(np.float64) ** 2,
                               spec["k"], f"streamed {tag} x{ranks}")
        report[tag]["min_abs_r_vs_one_rank"] = min_abs_r(
            many[0][f"scores_{tag}"], one[f"scores_{tag}"], report[tag]["separated"])
        if report[tag]["min_abs_r_vs_one_rank"] <= 0.999:
            raise AssertionError(f"streamed {tag} x{ranks} disagrees with one rank")
    return report


def check_eigensnp(ranks: int, device: str, work: Path, d: int = 4000,
                   n: int = 200, n_blocks: int = 16, seed: int = 21,
                   degenerate_tail: bool = False, split_legs: bool = True,
                   refine_passes: int = 3, force_streaming: bool = False,
                   timeout_s: float = 600) -> dict:
    """EigenSNP at `ranks` ranks against one rank and the float64 PCA.
    `degenerate_tail` makes the last quarter of the SNPs monomorphic, so
    that QC drops them all and (with four ranks over four blocks) the last
    rank owns no row; one block (`n_blocks=1`) makes the blocks cross the
    ranks, which takes the host-accessor stages 1-2; `force_streaming`
    runs both on the host-streamed container."""
    geno = structured_genotypes(seed, d, n, fst=0.08, missing=0.005)
    if degenerate_tail:
        geno[3 * d // 4:] = 0
    blocks = write_fileset(work / "cohort", geno, n_blocks)
    spec = dict(device=device, diagnostics=True, force_streaming=force_streaming,
                prep=dict(bed_path=str(work / "cohort"), ld_block_path=blocks),
                algo=dict(k_global=5, refine_passes=refine_passes,
                          min_subset_size=n // 2,
                          subset_factor=0.5,
                          max_subset_size=n // 2))
    one = eigensnp_worker(dict(spec, diagnostics=False))
    if split_legs:
        spec["checkpoint_dir"] = str(work / "ckpt")
    many = run_ranks(eigensnp_worker, ranks, (spec,), device=device,
                     timeout_s=timeout_s)
    for m in many:
        for key in ("keep", "mean", "std"):
            np.testing.assert_array_equal(m[key], one[key], err_msg=key)
    kept = geno[one["keep"]]
    v_true, ev_true = float64_pcs(kept, one["mean"], one["std"], 5)
    n_minus_1 = n - 1
    report = {"one": hold_pcs(one["scores"], v_true, ev_true,
                              one["eigenvalues"] * n_minus_1, 5, "eigensnp x1"),
              "many": hold_pcs(many[0]["scores"], v_true, ev_true,
                               many[0]["eigenvalues"] * n_minus_1, 5,
                               f"eigensnp x{ranks}"),
              "matrix_path": many[0]["matrix_path"],
              "container": many[0]["container"],
              "n_pca_snps": len(one["keep"]),
              "rank_rows": [int(np.searchsorted(one["keep"], hi)
                                - np.searchsorted(one["keep"], lo))
                            for lo, hi in many[0]["scan_ranges"]]}
    if split_legs:
        report["split"] = hold_pcs(many[0]["split_scores"], v_true, ev_true,
                                   many[0]["split_eigenvalues"] * n_minus_1, 5,
                                   f"eigensnp x{ranks} split legs")
    sep = report["many"]["separated"]
    report["min_abs_r_vs_one_rank"] = min_abs_r(many[0]["scores"], one["scores"], sep)
    if report["min_abs_r_vs_one_rank"] <= 0.999:
        raise AssertionError(f"eigensnp x{ranks} disagrees with one rank")
    return report


def check_vcf(ranks: int, device: str, work: Path, v: int = 3000, n: int = 150,
              n_files: int = 3, seed: int = 31, timeout_s: float = 600) -> dict:
    geno = structured_genotypes(seed, v, n, missing=0.0)
    write_vcf_dir(work / "vcf", geno, n_files)
    k = 4
    spec = dict(vcf_dir=str(work / "vcf"), k=k, device=device,
                prefix=str(work / "one"))
    vcf_worker(spec)
    spec["prefix"] = str(work / "many")
    run_ranks(vcf_worker, ranks, (spec,), device=device, timeout_s=timeout_s)
    freq = geno.sum(1, dtype=np.int64) / (2.0 * n)
    kept = geno[np.minimum(freq, 1 - freq) >= 0.01]
    v_true, ev_true = float64_pcs(kept, kept.mean(1), None, k, center_only=True)
    report = {}
    for tag in ("one", "many"):
        pcs = np.loadtxt(work / f"{tag}.vcf.pca.tsv", skiprows=1,
                         usecols=range(1, k + 1), delimiter="\t")
        evs = np.loadtxt(work / f"{tag}.eigenvalues.tsv", skiprows=1, usecols=1,
                         delimiter="\t")
        report[tag] = hold_pcs(pcs, v_true, ev_true, evs * (n - 1), k,
                               f"vcf {tag}")
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--work", default=None, help="scratch directory "
                    "(default: a temporary one)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("multichip: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(args.work or tmp)
        work.mkdir(parents=True, exist_ok=True)
        report = {"ranks": args.ranks, "device": args.device}
        if args.device == "cuda":
            report["card"] = torch.cuda.get_device_name(0)
            report["device_count"] = torch.cuda.device_count()
        report["passes"] = check_passes(args.ranks, args.device)
        (work / "eigensnp").mkdir(exist_ok=True)
        report["eigensnp"] = check_eigensnp(args.ranks, args.device,
                                            work / "eigensnp")
        report["vcf"] = check_vcf(args.ranks, args.device, work / "vcfrun")
        report["streamed"] = check_streamed(args.ranks, args.device)
        (work / "eigensnp_streamed").mkdir(exist_ok=True)
        report["eigensnp_streamed"] = check_eigensnp(
            args.ranks, args.device, work / "eigensnp_streamed", split_legs=False,
            force_streaming=True)
    report["ok"] = True
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
