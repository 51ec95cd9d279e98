"""The EigenSNP job: the workflow's two calls on a PLINK fileset.

Set-up makes the cohort on the device and writes it as a PLINK 1 fileset
with an LD-block file of the configuration's block count under the run's
temporary directory.  A job is `models.prepare.prepare_data` (sample QC,
the SNP QC scan and the LD mapping) and then
`models.eigensnp.compute_eigensnp_pca` with the configuration's QC and
EigenSNP parameters and the job's seed; the outputs stay in memory (no
TSV is written).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import generate
from benchmark.reference import compare, decode, pca, qc

# Rows of the BED file the reference decodes at a time at or below
# `pca.GRAM_MAX_SAMPLES` samples; above it, `pca.BLOCK_ELEMS` genotypes'
# worth.
REF_ROWS = 65_536


def setup(ctx) -> dict:
    cfg = ctx.config
    d, n = cfg["sizes"]["n_snps"], cfg["sizes"]["n_samples"]
    cohort = generate.make_cohort(cfg["model"], d, n, ctx.seed, ctx.device)
    fs = cfg["fileset"]
    bp = generate.snp_positions(d, ctx.seed, fs["first_bp"], fs["span_bp"])
    prefix = os.path.join(ctx.tmpdir, "cohort")
    blocks = generate.write_fileset(cohort, prefix, fs["chrom"], bp, fs["ld_blocks"])
    return {"ctx": ctx, "prefix": prefix, "blocks": blocks, "n": n, "d": d}


def run(state, index: int) -> dict:
    from torch.profiler import record_function

    from genomic_pca_tpu_torch.config import DataPrepConfig, EigenSnpConfig
    from genomic_pca_tpu_torch.models.eigensnp import compute_eigensnp_pca
    from genomic_pca_tpu_torch.models.prepare import prepare_data

    ctx = state["ctx"]
    t0 = time.perf_counter()
    with record_function("bench.prepare_data"):
        prep = prepare_data(DataPrepConfig(bed_path=state["prefix"],
                                           ld_block_path=state["blocks"],
                                           **ctx.config["qc"]), device=ctx.device)
    qc_s = time.perf_counter() - t0
    with record_function("bench.compute_eigensnp_pca"):
        res = compute_eigensnp_pca(
            prep, EigenSnpConfig(seed=ctx.seed + index + 1, **ctx.config["eigensnp"]),
            device=ctx.device)
    return {"scores": res.scores, "evals": res.eigenvalues, "loadings": res.loadings,
            "kept": prep.pca_snp_orig_indices, "mean": prep.mean, "std": prep.std,
            "qc_s": qc_s, "stage_seconds": res.stage_seconds}


def release(state) -> None:
    pass


def _read_bed(state):
    """The fileset's packed rows on the device, REF_ROWS at a time at or
    below `pca.GRAM_MAX_SAMPLES` samples, else `pca.BLOCK_ELEMS` // N."""
    n = state["n"]
    rows = REF_ROWS if pca.exact(n) else max(1, pca.BLOCK_ELEMS // n)
    raw = np.memmap(state["prefix"] + ".bed", dtype=np.uint8, mode="r", offset=3,
                    shape=(state["d"], -(-n // 4)))
    dev = state["ctx"].device
    for lo in range(0, state["d"], rows):
        yield torch.from_numpy(np.array(raw[lo:lo + rows])).to(dev)


def reference(state, rounding=None, seed=None):
    """(keep, mean, std, V, eigenvalues, blocks) of the fileset: the QC
    on exact counts, then the judge's PCA of the kept rows (`pca.solve`:
    the float64 Gram, or above `pca.GRAM_MAX_SAMPLES` samples subspace
    iteration over float32 blocks from `seed`, the run's by default),
    every operand rounded to `rounding` for the control; `blocks` yields
    the kept rows standardized and rounded as the solver read them."""
    ctx, n = state["ctx"], state["n"]
    cnt = torch.cat([decode.counts(decode.codes(p, n)) for p in _read_bed(state)])
    keep, mean, std = qc.snp_qc(cnt.cpu().numpy(), n, ctx.config["qc"])
    dev = ctx.device
    keep_t = torch.as_tensor(keep, device=dev)
    mean_t = torch.as_tensor(mean, device=dev)
    std_t = torch.as_tensor(std, device=dev)
    dtype = torch.float64 if pca.exact(n) else torch.float32

    def blocks():
        lo = 0
        for p in _read_bed(state):
            r = p.shape[0]
            sel = keep_t[lo:lo + r]
            yield decode.standardized(p[sel], n, mean_t[lo:lo + r][sel],
                                      std_t[lo:lo + r][sel], dtype)
            lo += r

    v, ev = pca.solve(blocks, n, ctx.config["eigensnp"]["k_global"], dev,
                      seed=ctx.seed if seed is None else seed, rounding=rounding)
    return keep, mean, std, v, ev, pca.rounded(blocks, rounding)


def check(state, records) -> list:
    """Per job: `kept_mismatch`, `moment_err`, `pc_err`, the largest of
    `score_sin`, `loading_sin` and `eval_err` (reported beside it), and
    `ritz_err` over all k PCs with their loadings, against the data.  The
    scores alone do not separate the program from the control (an fp8
    rounding of each row's three levels averages out over 2^20 rows in
    the sample space), the loadings and eigenvalues do."""
    k = state["ctx"].config["eigensnp"]["k_global"]
    n = state["n"]
    if "reference" not in state:
        keep, mean, std, v, ev, blocks = reference(state)
        ev = ev.cpu().numpy()
        m = compare.separated_prefix(ev, k)
        if m == 0:
            raise RuntimeError("the reference spectrum has no gap among the first "
                               f"{k} PCs: nothing to compare")
        u = pca.row_loadings(blocks, v[:, :m])
        state["reference"] = keep, mean, std, v.cpu().numpy(), ev, m, u, blocks
    keep, mean, std, v, ev, m, u, blocks = state["reference"]
    kept = np.flatnonzero(keep)
    same = []
    for r in records:
        prog = np.zeros(len(keep), bool)
        prog[r["kept"]] = True
        same.append(prog)
    # The loadings are held to the reference's rows only where the kept
    # set is the reference's; a job whose set differs fails on
    # `kept_mismatch` already.
    sums = pca.ritz_sums(blocks, [(r["scores"], r["evals"]) for r in records], n,
                         state["ctx"].device,
                         loadings=[r["loadings"] if (p == keep).all() else None
                                   for r, p in zip(records, same)])
    out = []
    for r, prog, s in zip(records, same, sums):
        ok = bool((prog == keep).all())
        got = compare.pca_numbers(r["scores"], r["evals"], v, ev, m,
                                  r["loadings"] if ok else None, u)
        got.setdefault("loading_sin", 1.0)
        got["pc_err"] = max(got["score_sin"], got["loading_sin"], got["eval_err"])
        got.update(compare.ritz_numbers(r["evals"], s) if ok
                   else {"ritz_err": float("inf")})
        got["kept_mismatch"] = int((prog != keep).sum())
        got["moment_err"] = (compare.moment_err(r["mean"], r["std"], mean[kept], std[kept])
                             if ok else float("inf"))
        got["pcs"] = m
        out.append(got)
    return out


def control(state, seed: int, rounding) -> dict:
    """The reference in the program's place, its operands rounded to
    `rounding`: its QC, moments, scores, eigenvalues and loadings."""
    k = state["ctx"].config["eigensnp"]["k_global"]
    keep, mean, std, v, ev, blocks = reference(state, rounding=rounding, seed=seed)
    n = state["n"]
    u = pca.row_loadings(blocks, v[:, :k])
    sigma = torch.sqrt(ev[:k] * max(n - 1, 1))
    return {"scores": (v[:, :k] * sigma[None, :]).cpu().numpy(),
            "evals": ev[:k].cpu().numpy(), "loadings": u,
            "kept": np.flatnonzero(keep), "mean": mean[keep], "std": std[keep]}
