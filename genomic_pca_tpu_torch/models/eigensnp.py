"""EigenSNP two-stage PCA on one device: per-LD-block local bases ->
condensed global eigensolve -> refinement through the matrix container.

Counterpart of `genomic_pca_tpu/models/eigensnp.py` on the resident
container (parallel/sharded.py, packed or dense int8) and on the
host-streamed one (ops/streaming.py):

  Stage 1 - for each LD block, a randomized SVD of the standardized block
  restricted to a sample subset (`cfg.subset_size`), with
  `components_per_block` components.  Blocks come zero-padded to row
  buckets and run as one batched rSVD per (bucket, c_b) chunk, the batch
  dimension standing where the reference uses `vmap`; each block's sketch
  comes from `generator_for_stage(seed, "eigensnp_local_sketch",
  unit=block + 1)`.  They are sliced from the resident matrix
  (`fetch_blocks_device`) when every block is a contiguous run of PCA
  SNPs; otherwise (a streamed container, or a nested or overlapping block
  file) the host accessor reads each chunk's blocks from the BED - raw
  PLINK bytes standardized on the device under the packed pipeline with
  the full sample set, standardized f32 blocks else - on worker threads
  two chunks ahead of the device.

  Stage 2 - every sample projected through every block basis, stacked in
  block order into the condensed (C, N) matrix; its randomized SVD gives
  a k-wide score basis, widened with random columns to the refinement
  width.

  Refinement - `refine_passes` exact passes of subspace iteration over
  the full matrix, the Rayleigh-Ritz eigensolve and the loadings, all in
  one `pca_core` of a resident container; runs with checkpoints or
  diagnostics, and streamed containers, take the per-pass path, so that
  each pass is saved and its convergence observable.  A streamed
  container ends with `tsq_and_project` (the A B products kept on the
  device), else `tsq_and_capture`, so the loadings need no extra pass.

Several ranks (parallel/mesh.py): stages 1-2 run on each rank over the
blocks it owns - on the resident path the blocks whose rows it holds
(every block inside one rank and one row segment, `rank_of_runs`), on the
host-accessor path (a streamed container, or blocks that cross ranks) the
blocks whose first SNP lies in its scan range - each block with the
sketch of the one-rank run; bases and singular values are gathered and
the condensed rows merged in block order on every rank.  Stage 2 and the
refinement run replicated through the multi-rank container.  Checkpoints
are written by rank 0 and read by every rank, a barrier between.

Random draws come from the port's seeded generators (utils/rng.py), so
the sample subset and the sketches differ from the reference's jax
threefry draws: results agree with the reference to the accuracy of the
algorithm, not bit for bit.

Before the matrix loads, `memory_preflight` (utils/system.py) logs the
device bytes the run will upload: the resident matrix once, or a
streamed container's strips on every full-matrix pass the run still has
to make (`_planned_matrix_passes`: resumed checkpoints and a stop-after
leg cut the list).

Not ported: the ahead-of-time compile threads of the reference
(`compile_only`), which have no counterpart in eager PyTorch.
"""

from __future__ import annotations

import dataclasses
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from genomic_pca_tpu_torch.config import EigenSnpConfig
from genomic_pca_tpu_torch.errors import ComputeError
from genomic_pca_tpu_torch.models.pca import lane_fill_width
from genomic_pca_tpu_torch.models.prepare import PreparedData
from genomic_pca_tpu_torch.ops import kernels
from genomic_pca_tpu_torch.ops.rsvd import rsvd, sketch_width
from genomic_pca_tpu_torch.parallel import mesh
from genomic_pca_tpu_torch.models.prepare import group_memory_budget
from genomic_pca_tpu_torch.utils.checkpoint import StageCheckpointer, fingerprint
from genomic_pca_tpu_torch.utils.profiling import span, to_host
from genomic_pca_tpu_torch.utils.rng import generator_for_stage, normal
from genomic_pca_tpu_torch.utils.system import memory_preflight

log = logging.getLogger(__name__)

# Elements of one stage-1+2 chunk's full-width f32 block batch (1 GiB).
_STAGE12_BUDGET_ELEMS = 256 * 1024 * 1024


@dataclasses.dataclass
class EigenSnpResult:
    scores: np.ndarray  # (N, K) f32 final sample PC scores
    eigenvalues: np.ndarray  # (K,) f64
    loadings: np.ndarray  # (D, K) f32 per-SNP loadings
    diagnostics: Optional[Dict] = None
    # Stage wall-clocks, each a span's (utils/profiling.py): the data
    # preparation's (`prep.stage_seconds`: open / qc_scan / ld_map), then
    # matrix_load / stages_1_2 / global_pca / refinement_finalize (the
    # spans gp.eigensnp.load / stages12 / global / refine).
    stage_seconds: Optional[Dict[str, float]] = None
    # The matrix container that ran: "device-resident" or "host-streamed".
    container: Optional[str] = None


def _bucket_rows(d: int, bucket: int = 512) -> int:
    """Next bucket multiple >= d (bounds the number of batch shapes)."""
    return max(bucket, ((d + bucket - 1) // bucket) * bucket)


def _pow2_at_most(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def _c_of(cfg: EigenSnpConfig, n_snps: int, n_subset: int) -> int:
    return min(cfg.components_per_block, n_snps, n_subset)


def _group_plan(prep: PreparedData, cfg: EigenSnpConfig, subset: np.ndarray,
                width: int, block_ids: List[int],
                max_bucket: Optional[int] = None):
    """Ordered [((bucket, c_b), block indices, chunk_b)] of the blocks
    `block_ids`: grouped by row bucket (capped at `max_bucket`) and
    component count, each group run in chunks of chunk_b blocks (a power
    of two whose (chunk_b, bucket, width) f32 batch fits the budget)."""
    groups: Dict[tuple, List[int]] = {}
    for b_idx in block_ids:
        d_b = len(prep.blocks[b_idx].pca_snp_ids)
        bucket = _bucket_rows(d_b)
        if max_bucket is not None:
            bucket = min(bucket, max_bucket)
        groups.setdefault((bucket, _c_of(cfg, d_b, len(subset))), []).append(b_idx)
    plan = []
    for (bucket, c_b), idxs in sorted(groups.items()):
        b_cap = max(1, _STAGE12_BUDGET_ELEMS // (bucket * max(width, 1)))
        plan.append(((bucket, c_b), idxs, _pow2_at_most(min(b_cap, len(idxs)))))
    return plan


def _device_group_plan(a, prep: PreparedData, cfg: EigenSnpConfig,
                       subset: np.ndarray, block_ids: List[int]):
    """The plan of the resident path: buckets capped at the rows of one
    rank, batches of full container width."""
    return _group_plan(prep, cfg, subset, a.n_pad, block_ids, max_bucket=a.d_pad)


def _chunks(plan):
    """(bucket, c_b, chunk, chunk_b) work items of a plan, in order."""
    for (bucket, c_b), idxs, chunk_b in plan:
        for pos in range(0, len(idxs), chunk_b):
            yield bucket, c_b, idxs[pos:pos + chunk_b], chunk_b


def _choose_sample_subset(cfg: EigenSnpConfig, n_samples: int) -> np.ndarray:
    """Sample subset for local basis learning (sorted), drawn from the
    port's generator for "eigensnp_sample_subset" (not the reference's
    subset: the generators differ)."""
    n_subset = cfg.subset_size(n_samples)
    if n_subset >= n_samples:
        return np.arange(n_samples, dtype=np.int64)
    gen = generator_for_stage(cfg.seed, "eigensnp_sample_subset")
    perm = torch.randperm(n_samples, generator=gen).numpy()
    return np.sort(perm[:n_subset]).astype(np.int64)


def _blocks_as_runs(blocks) -> Optional[np.ndarray]:
    """(B, 2) [start, len] when every block is a contiguous PcaSnpId run,
    else None (nested or overlapping block files can break that)."""
    runs = np.empty((len(blocks), 2), dtype=np.int64)
    for i, b in enumerate(blocks):
        ids = b.pca_snp_ids
        if len(ids) == 0 or int(ids[-1]) - int(ids[0]) + 1 != len(ids):
            return None
        runs[i] = (int(ids[0]), len(ids))
    return runs


def _local_sketches(seed: int, chunk: List[int], chunk_b: int, n_cols: int,
                    ell: int, device) -> torch.Tensor:
    """(chunk_b, n_cols, ell) per-block stage-1 sketches: block b draws
    from unit b + 1; batch padding from unit 0."""
    units = [b + 1 for b in chunk] + [0] * (chunk_b - len(chunk))
    return torch.stack([
        normal((n_cols, ell), seed, "eigensnp_local_sketch", "cpu", unit=u)
        for u in units
    ]).to(device)


def _stages12(batches, prep: PreparedData, cfg: EigenSnpConfig,
              subset: np.ndarray, saved_bases: Optional[List[np.ndarray]],
              device: torch.device):
    """Stages 1+2 over (bucket, c_b, chunk, chunk_b, xs_full) batches,
    xs_full the (chunk_b, bucket, >= N) f32 standardized blocks of the
    chunk on `device` (batch padding: zero blocks): restrict to the
    subset, batched local rSVD (CholQR2 stabilizer), project all samples.
    With `saved_bases` (a stage-1 checkpoint) only the projection runs.

    Returns (local_bases [np arrays], svals dict or None, y (C, N) on the
    device)."""
    n = prep.n_samples
    full_cols = len(subset) >= n
    subset_dev = torch.as_tensor(subset, device=device)
    parts = []  # (chunk, c_b, u batch, s batch or None, out batch)
    for bucket, c_b, chunk, chunk_b, xs_full in batches:
        if saved_bases is not None:
            us = [saved_bases[i] for i in chunk]
            us += [np.zeros_like(us[0])] * (chunk_b - len(chunk))
            u_b = torch.as_tensor(np.stack(us), device=device)
            s_b = None
        else:
            xs_sub = (xs_full[:, :, :n] if full_cols
                      else xs_full[:, :, subset_dev])
            ell = sketch_width(c_b, cfg.local_oversampling, bucket, len(subset))
            omega = _local_sketches(cfg.seed, chunk, chunk_b, len(subset), ell,
                                    device)
            u_b, s_b, _ = rsvd(xs_sub, omega, k=c_b,
                               n_oversamples=cfg.local_oversampling,
                               n_power_iter=cfg.local_power_iter, orth="cholqr2")
            del xs_sub
        out = u_b.mT @ xs_full  # (chunk_b, c_b, width)
        del xs_full
        parts.append((list(chunk), c_b, u_b, s_b, out))
    return _assemble_condensed(parts, n, len(prep.blocks), device)


def _stages12_device(a, prep: PreparedData, cfg: EigenSnpConfig,
                     subset: np.ndarray, runs: np.ndarray,
                     saved_bases: Optional[List[np.ndarray]]):
    """Stages 1+2 with every chunk's blocks sliced from the resident
    matrix (`fetch_blocks_device`), each rank over the blocks it holds."""
    owned = [int(b) for b in np.nonzero(a.rank_of_runs(runs) == a.rank)[0]]

    def batches():
        for bucket, c_b, chunk, chunk_b in _chunks(
                _device_group_plan(a, prep, cfg, subset, owned)):
            starts = np.zeros(chunk_b, dtype=np.int64)
            lens = np.zeros(chunk_b, dtype=np.int64)
            starts[:len(chunk)] = runs[chunk, 0]
            lens[:len(chunk)] = runs[chunk, 1]
            yield bucket, c_b, chunk, chunk_b, a.fetch_blocks_device(starts, lens,
                                                                     bucket)

    return _stages12(batches(), prep, cfg, subset, saved_bases, a.device)


def _stages12_host(prep: PreparedData, cfg: EigenSnpConfig, subset: np.ndarray,
                   saved_bases: Optional[List[np.ndarray]], device):
    """Stages 1+2 through the host block accessor, for streamed containers
    and block files whose blocks are not contiguous runs (the reference's
    `_stages12_host`).  With the packed pipeline and the full sample set
    each chunk's blocks come as raw PLINK bytes (`fetch_block_packed`,
    16x fewer bytes to upload than f32) and standardize on the device in
    f32; otherwise as standardized f32 blocks (`fetch_block_standardized`).
    The host gathers run on two worker threads, two chunks ahead of the
    device; each block's bytes upload once for both the subset rSVD and
    the all-sample projection.  A checkpoint resume groups blocks by the
    shapes of the saved bases.  With several ranks each rank takes the
    blocks whose first SNP lies in its scan range (`_host_blocks`)."""
    n = prep.n_samples
    packed = prep.supports_packed_blocks
    owned = _host_blocks(prep)
    if saved_bases is None:
        plan = _group_plan(prep, cfg, subset, n, owned)
    else:
        groups: Dict[tuple, List[int]] = {}
        for b_idx in owned:
            groups.setdefault(tuple(saved_bases[b_idx].shape), []).append(b_idx)
        plan = [(key, idxs, _pow2_at_most(min(
                    max(1, _STAGE12_BUDGET_ELEMS // (key[0] * n)), len(idxs))))
                for key, idxs in sorted(groups.items())]
    tasks = list(_chunks(plan))

    def gather(task):
        """Host arrays of one chunk (on a worker thread)."""
        bucket, _c_b, chunk, chunk_b = task
        if packed:
            raws, ms, ivs = zip(*(prep.fetch_block_packed(
                prep.blocks[i].pca_snp_ids, pad_rows_to=bucket) for i in chunk))
            pad = chunk_b - len(chunk)  # batch padding: inert all-missing blocks
            return (np.stack(list(raws) + [np.full_like(raws[0], 0x55)] * pad),
                    np.stack(list(ms) + [np.zeros_like(ms[0])] * pad),
                    np.stack(list(ivs) + [np.zeros_like(ivs[0])] * pad))
        xs = [prep.fetch_block_standardized(prep.blocks[i].pca_snp_ids,
                                            pad_rows_to=bucket) for i in chunk]
        xs += [np.zeros_like(xs[0])] * (chunk_b - len(chunk))
        return np.stack(xs)

    def upload(fetched) -> torch.Tensor:
        """(chunk_b, bucket, N) f32 standardized blocks on the device."""
        if not packed:
            return torch.as_tensor(fetched, device=device)
        pk8, mean, inv = (torch.as_tensor(x, device=device) for x in fetched)
        b, r, n4 = pk8.shape
        x = kernels.standardize_packed(pk8.reshape(b * r, n4),
                                       mean.reshape(-1, 1), inv.reshape(-1, 1),
                                       "f32")
        return x.reshape(b, r, 4 * n4)[:, :, :n]

    def batches():
        depth = 2  # chunks gathered ahead of the one on the device
        with ThreadPoolExecutor(depth) as ex:
            futs = [ex.submit(gather, t) for t in tasks[:depth]]
            for i, task in enumerate(tasks):
                fetched = futs[i].result()
                futs[i] = None  # drop the host arrays with the future
                if i + depth < len(tasks):
                    futs.append(ex.submit(gather, tasks[i + depth]))
                yield (*task, upload(fetched))

    return _stages12(batches(), prep, cfg, subset, saved_bases, torch.device(device))


def _host_blocks(prep: PreparedData) -> List[int]:
    """The blocks this rank runs through the host accessor: those whose
    first PCA SNP lies in its block-aligned scan range, so that a rank
    reads the BED rows it scanned (every block has one owner); all of
    them on one rank."""
    if prep.scan_ranges is None:
        return list(range(len(prep.blocks)))
    lo, hi = prep.scan_ranges[mesh.process_index()]
    first = prep.pca_snp_orig_indices[[int(b.pca_snp_ids[0]) for b in prep.blocks]]
    return [int(b) for b in np.nonzero((first >= lo) & (first < hi))[0]]


def _assemble_condensed(parts, n: int, n_blocks: int, device: torch.device):
    """Bases and singular values to the host, one transfer per chunk, and
    the condensed matrix y (C, n) in block order on the device (c_b rows
    per block, batch-padding rows dropped).  `parts` is
    [(chunk, c_b, u, s or None, out)] in any order, of this rank's
    blocks; with several ranks the bases and singular values are
    gathered, and y is merged by an all-reduce of each rank's rows in
    place among zeros (exact: every entry is one rank's value)."""
    bases: Dict[int, np.ndarray] = {}
    svals: Dict[int, np.ndarray] = {}
    rows: Dict[int, torch.Tensor] = {}
    for chunk, _c_b, u_b, s_b, out in parts:
        u_np = to_host(u_b).numpy()
        s_np = to_host(s_b).numpy() if s_b is not None else None
        for j, i in enumerate(chunk):
            bases[i] = u_np[j]
            if s_np is not None:
                svals[i] = s_np[j]
            rows[i] = out[j, :, :n]
    if mesh.process_count() == 1:
        y = torch.cat([rows[i] for i in range(n_blocks)])
    else:
        for b, s in mesh.all_gather_object((bases, svals)):
            bases.update(b)
            svals.update(s)
        ofs = np.concatenate([[0], np.cumsum([bases[i].shape[1]
                                              for i in range(n_blocks)])])
        y = torch.zeros((int(ofs[-1]), n), dtype=torch.float32, device=device)
        for i, r in rows.items():
            y[int(ofs[i]):int(ofs[i + 1])] = r
        y = mesh.all_reduce_sum(y)
    return [bases[i] for i in range(n_blocks)], (svals or None), y


def _stage2_basis(y: torch.Tensor, seed: int, k: int, n_os: int,
                  n_pi: int) -> torch.Tensor:
    """Stage 2: rSVD of the condensed matrix (C, N) and the orthonormal
    (N, k) score basis."""
    c, n = y.shape
    omega = normal((n, sketch_width(k, n_os, c, n)), seed,
                   "eigensnp_global_sketch", y.device)
    _, _, vt_g = rsvd(y, omega, k=k, n_oversamples=n_os, n_power_iter=n_pi)
    return torch.linalg.qr(vt_g.T)[0]  # (N, k)


def _widen(s_basis: torch.Tensor, seed: int, ell_ref: int) -> torch.Tensor:
    """The score basis widened with random columns to the refinement
    width, re-orthonormalised."""
    n, k = s_basis.shape
    if ell_ref <= k:
        return s_basis
    extra = normal((n, ell_ref - k), seed, "eigensnp_refine_fill", s_basis.device)
    return torch.linalg.qr(torch.cat([s_basis, extra], dim=1))[0]


def _checkpointer(directory: Optional[str], fp: str) -> StageCheckpointer:
    """The stage checkpointer, made by rank 0 first (which writes or
    invalidates the directory's metadata), then by the other ranks."""
    if mesh.process_index() == 0:
        ckpt = StageCheckpointer(directory, fp)
    mesh.barrier()
    if mesh.process_index() != 0:
        ckpt = StageCheckpointer(directory, fp)
    return ckpt


def _save(ckpt: StageCheckpointer, stage: str, arrays) -> None:
    """Save a checkpoint from rank 0; every rank waits until it is
    written."""
    if not ckpt.enabled:
        return
    if mesh.process_index() == 0:
        ckpt.save(stage, arrays)
    mesh.barrier()


def _has(ckpt: StageCheckpointer, stage: str) -> bool:
    """Whether `stage`'s checkpoint is present as rank 0 sees it, on every
    rank: a rank that looks after rank 0 has written it in this same run
    would otherwise take another branch than rank 0 (and skip the
    barrier of `_save`)."""
    if not ckpt.enabled:
        return False
    return bool(mesh.all_gather_object(ckpt.has(stage))[0])


def _load(ckpt: StageCheckpointer, stage: str):
    """`ckpt.load(stage)` where rank 0 finds the checkpoint, else None."""
    return ckpt.load(stage) if _has(ckpt, stage) else None


def _ckpt_stop(name: str, stop_after: Optional[str]) -> bool:
    if stop_after != name:
        return False
    log.info("EigenSNP stopping after checkpoint %r (stop_after_checkpoint); "
             "re-run with the same checkpoint dir to resume.", name)
    return True


def _planned_matrix_passes(cfg: EigenSnpConfig, ckpt: StageCheckpointer,
                           stop_after_checkpoint: Optional[str],
                           diagnostics: bool) -> List[str]:
    """The full-matrix passes this run still makes, given the checkpoints
    present and a stop-after leg: stages 1-2 (one pass, skipped when the
    stage-2 basis is saved and no diagnostics are asked for), each
    refinement pass not yet saved, and the final tsq and loadings pass.
    The JAX `_planned_matrix_passes`
    (genomic_pca_tpu/models/eigensnp.py:819)."""
    passes: List[str] = []
    if not (_has(ckpt, "stage2_basis") and not diagnostics):
        passes.append("stages_1_2")
    if stop_after_checkpoint in ("stage1_bases", "stage2_basis"):
        return passes
    resume_at = 0
    for p in reversed(range(cfg.refine_passes)):
        if _has(ckpt, f"refine_pass_{p}"):
            resume_at = p + 1
            break
    for p in range(resume_at, cfg.refine_passes):
        passes.append(f"refine_pass_{p}")
        if stop_after_checkpoint == f"refine_pass_{p}":
            return passes
    passes.append("capture_finalize")
    return passes


def compute_eigensnp_pca(
    prep: PreparedData,
    cfg: EigenSnpConfig,
    device="cuda",
    checkpoint_dir: Optional[str] = None,
    stop_after_checkpoint: Optional[str] = None,
    force_streaming: bool = False,
) -> Optional[EigenSnpResult]:
    """The two-stage pipeline on prepared data, on `device`.

    `checkpoint_dir` saves stage checkpoints and resumes from them;
    `stop_after_checkpoint` (needs `checkpoint_dir`) returns None right
    after the named checkpoint (stage1_bases, stage2_basis,
    refine_pass_<p>) is saved, and a later run resumes there.
    `force_streaming` takes the host-streamed container whatever the
    memory budget (what `load_matrix` does on its own past 60% of the
    device's memory)."""
    n = prep.n_samples
    d = prep.n_pca_snps
    if d == 0 or not prep.blocks:
        raise ComputeError("No PCA SNPs / LD blocks available for EigenSNP.")
    k = min(cfg.k_global, max(n - 1, 1), d)

    ckpt = _checkpointer(
        checkpoint_dir, fingerprint(cfg, n, d, [b.tag for b in prep.blocks])
    )
    if stop_after_checkpoint is not None:
        if not ckpt.enabled:
            raise ComputeError("stop_after_checkpoint requires a checkpoint_dir "
                               "(--eigensnp-checkpoint-dir).")
        order = ["stage1_bases", "stage2_basis"] + [
            f"refine_pass_{p}" for p in range(cfg.refine_passes)
        ]
        if stop_after_checkpoint not in order:
            raise ComputeError(
                f"stop_after_checkpoint {stop_after_checkpoint!r} is not a "
                f"checkpoint of this run (have {sorted(order)})."
            )
        # A retried leg whose checkpoint (or any later one) exists is
        # complete: it must not run on through the rest of the pipeline.
        done = next((s for s in order[order.index(stop_after_checkpoint):]
                     if _has(ckpt, s)), None)
        if done is not None:
            log.info("EigenSNP checkpoint %r already present in %s (stop point "
                     "%r); this stop-after leg is complete.", done,
                     checkpoint_dir, stop_after_checkpoint)
            return None

    diag: Optional[Dict] = (
        {"blocks": []}
        if (cfg.collect_diagnostics or cfg.diagnostic_block_tag is not None)
        else None
    )
    tags = [b.tag for b in prep.blocks]
    if cfg.diagnostic_block_tag is not None and cfg.diagnostic_block_tag not in tags:
        raise ComputeError(
            f"--eigensnp-diagnostic-block-tag {cfg.diagnostic_block_tag!r} "
            f"matches no LD block (have {len(tags)} blocks, e.g. {tags[:3]})."
        )

    stage_seconds: Dict[str, float] = {}
    with span("gp.eigensnp.load") as stage:
        # ---- Memory preflight: the uploads of this rank's planned passes --
        streamed = prep.will_stream(force_streaming, device=device)
        memory_preflight(
            per_pass_device_bytes=(prep.estimate_streamed_pass_bytes() if streamed
                                   else prep.estimate_resident_bytes()),
            n_passes=(max(len(_planned_matrix_passes(
                cfg, ckpt, stop_after_checkpoint, diag is not None)), 1)
                if streamed else 1),
            resident=not streamed,
            device_budget_bytes=group_memory_budget(device),
        )

        # ---- Matrix container; stages 1-2 slice their blocks from it, or
        # read them through the host accessor ------------------------------
        if force_streaming:
            a = prep.load_streaming_matrix(device, strip_size=cfg.snp_strip_size)
        else:
            a = prep.load_matrix(device, strip_size=cfg.snp_strip_size)
        container = "device-resident" if hasattr(a, "pca_core") else "host-streamed"
        runs = _blocks_as_runs(prep.blocks)
        use_device = runs is not None and hasattr(a, "fetch_blocks_device")
        if use_device and not a.runs_device_sliceable(runs):
            # Blocks across a row segment or a rank (a degenerate block file
            # under several ranks) are read through the host accessor.
            log.warning("LD blocks cross row segments or ranks; using the host "
                        "accessor path for stages 1-2.")
            use_device = False
        _sync(a.device)
    stage_seconds["matrix_load"] = stage.seconds
    log.info("EigenSNP matrix loaded (%s container, %s mode; stages 1-2 through "
             "the %s path) in %.1fs.", container, a.mode,
             "device-resident" if use_device else "host-accessor",
             stage_seconds["matrix_load"])

    with span("gp.eigensnp.stages12") as stage:
        # Refinement width: fill the 128 columns the kernels' sketch width is
        # tuned for (models/pca.lane_fill_width); `refine_width` overrides.
        ell_ref = (lane_fill_width(k, n, d) if cfg.refine_width is None
                   else max(k, min(cfg.refine_width, n, d)))
        use_pca_core = (hasattr(a, "pca_core") and not ckpt.enabled and diag is None
                        and cfg.refine_passes >= 1)

        # ---- Stages 1+2 ---------------------------------------------------
        subset = _choose_sample_subset(cfg, n)
        c_total = sum(_c_of(cfg, len(b.pca_snp_ids), len(subset)) for b in prep.blocks)
        local_bases = svals = y = saved_bases = None
        if _has(ckpt, "stage2_basis") and diag is None:
            # Only the condensed matrix (already reduced to the checkpointed
            # stage-2 basis) and diagnostics consume stages 1-2: skip them.
            log.info("EigenSNP stages 1+2 skipped (stage2_basis checkpoint "
                     "present; condensed rank %d).", c_total)
        else:
            saved = _load(ckpt, "stage1_bases")
            if saved is not None and len(saved) == len(prep.blocks):
                saved_bases = [saved[f"block_{i}"] for i in range(len(prep.blocks))]
            else:
                log.info("EigenSNP stage 1: %d blocks, sample subset %d / %d.",
                         len(prep.blocks), len(subset), n)
            if use_device:
                local_bases, svals, y = _stages12_device(a, prep, cfg, subset, runs,
                                                         saved_bases)
            else:
                local_bases, svals, y = _stages12_host(prep, cfg, subset, saved_bases,
                                                       a.device)
            if saved_bases is None:
                if diag is not None:
                    for b_idx, block in enumerate(prep.blocks):
                        ids = block.pca_snp_ids
                        diag["blocks"].append({
                            "tag": block.tag,
                            "num_snps": int(len(ids)),
                            "num_local_components": int(
                                _c_of(cfg, len(ids), len(subset))),
                            "pca_snp_id_start": int(ids[0]),
                            "pca_snp_id_end": int(ids[-1]),
                            "local_singular_values": svals[b_idx].tolist(),
                        })
                _save(ckpt, "stage1_bases",
                      {f"block_{i}": u for i, u in enumerate(local_bases)})
                if _ckpt_stop("stage1_bases", stop_after_checkpoint):
                    return None
        if diag is not None and cfg.diagnostic_block_tag is not None:
            b_idx = tags.index(cfg.diagnostic_block_tag)
            block = prep.blocks[b_idx]
            off = sum(_c_of(cfg, len(prep.blocks[i].pca_snp_ids), len(subset))
                      for i in range(b_idx))
            c_b = _c_of(cfg, len(block.pca_snp_ids), len(subset))
            diag["block_trace"] = {
                "tag": block.tag,
                "block_index": int(b_idx),
                "num_snps": int(len(block.pca_snp_ids)),
                "num_local_components": int(c_b),
                "subset_sample_indices": [int(x) for x in subset],
                "pca_snp_ids": [int(x) for x in block.pca_snp_ids],
                # Bases are bucket-padded (zero rows past d_b); trace the
                # real (d_b, c_b) basis.
                "local_basis": np.asarray(local_bases[b_idx])[
                    : len(block.pca_snp_ids)].tolist(),
                "local_singular_values": (
                    np.asarray(svals[b_idx]).tolist() if svals is not None else None),
                "condensed_projection": to_host(y[off:off + c_b]).numpy().tolist(),
            }
        _sync(a.device)
    stage_seconds["stages_1_2"] = stage.seconds
    if y is not None:
        log.info("EigenSNP stages 1+2: condensed matrix %s in %.1fs.",
                 tuple(y.shape), stage_seconds["stages_1_2"])

    with span("gp.eigensnp.global") as stage:
        condensed_spectrum = None
        if diag is not None:
            gram = y @ y.T if y.shape[0] <= n else y.T @ y
            sp = torch.sqrt(torch.clamp(torch.linalg.eigvalsh(gram), min=0.0))
            condensed_spectrum = to_host(sp.flip(0)).numpy()

        if c_total < k:
            log.warning(
                "Condensed feature rank %d < requested k_global %d; returning %d "
                "components (raise components_per_block or add LD blocks for "
                "more).", c_total, k, c_total)
            k = c_total

        saved = _load(ckpt, "stage2_basis")
        if saved is not None:
            s_basis = torch.as_tensor(saved["s_basis"], device=a.device)
        else:
            s_basis = _stage2_basis(y, cfg.seed, k, cfg.global_oversampling,
                                    cfg.global_power_iter)
            # Checkpoint runs save the k-wide basis, a resumable artifact.
            _save(ckpt, "stage2_basis", {"s_basis": to_host(s_basis).numpy()})
            if _ckpt_stop("stage2_basis", stop_after_checkpoint):
                return None
        s_basis = _widen(s_basis, cfg.seed, ell_ref)
        del y
        _sync(a.device)
    stage_seconds["global_pca"] = stage.seconds
    log.info("EigenSNP global PCA done in %.1fs.", stage_seconds["global_pca"])

    with span("gp.eigensnp.refine") as stage:
        # ---- Refinement + final eigensolve + loadings ---------------------
        refine_residuals: List[float] = []
        if use_pca_core:
            v_k, sigma_k, evals_k, loadings = a.pca_core(s_basis, cfg.refine_passes, k)
            sigma = to_host(sigma_k).numpy()
            scores = (to_host(v_k).numpy() * sigma[None, :]).astype(np.float32)
            loadings = loadings.astype(np.float32)
            eigenvalues = to_host(evals_k).numpy().astype(np.float64) / max(n - 1, 1)
        else:
            start_pass = 0
            for p in reversed(range(cfg.refine_passes)):
                saved = _load(ckpt, f"refine_pass_{p}")
                if saved is not None:
                    s_basis = torch.as_tensor(saved["s_basis"], device=a.device)
                    start_pass = p + 1
                    break
            for p in range(start_pass, cfg.refine_passes):
                s_new = torch.linalg.qr(a.gram_apply(s_basis))[0]
                if diag is not None:
                    # sin of the largest principal angle between consecutive
                    # bases: the refinement's convergence series.
                    cosines = torch.linalg.svdvals(s_new.T @ s_basis)
                    smin = float(to_host(torch.clamp(cosines.min(), 0.0, 1.0)))
                    refine_residuals.append(float(np.sqrt(max(0.0, 1.0 - smin**2))))
                s_basis = s_new
                _save(ckpt, f"refine_pass_{p}", {"s_basis": to_host(s_basis).numpy()})
                log.info("EigenSNP refinement pass %d/%d done.", p + 1,
                         cfg.refine_passes)
                if _ckpt_stop(f"refine_pass_{p}", stop_after_checkpoint):
                    return None
            # A streamed container fuses the Rayleigh-Ritz Gram with the A B
            # products: loadings = (A B) W / sigma without another pass over
            # the matrix, the products kept on the device within its budget
            # (tsq_and_project), else brought to the host (tsq_and_capture).
            project = ab = None
            got = (a.tsq_and_project(s_basis) if hasattr(a, "tsq_and_project")
                   else None)
            if got is not None:
                g, project = got
            elif hasattr(a, "tsq_and_capture"):
                g, ab = a.tsq_and_capture(s_basis)
            else:
                g = a.tsq_accumulate(s_basis)
            evals, w = torch.linalg.eigh(g)
            order = torch.argsort(evals, descending=True)
            evals = torch.clamp(evals[order][:k], min=0.0)
            w = w[:, order][:, :k]
            sigma_t = torch.sqrt(evals)
            v = s_basis @ w
            inv_sigma = torch.where(sigma_t > 0, 1.0 / torch.where(
                sigma_t > 0, sigma_t, torch.ones_like(sigma_t)), torch.zeros_like(sigma_t))
            scores = to_host(v * sigma_t[None, :]).numpy().astype(np.float32)
            if project is not None:
                c = project(to_host(w).numpy())
            elif ab is not None:
                c = ab @ to_host(w).numpy()
            else:
                c = a.right_apply(v)
            loadings = (c * to_host(inv_sigma).numpy()[None, :]).astype(np.float32)
            sigma = to_host(sigma_t).numpy()
            eigenvalues = to_host(evals).numpy().astype(np.float64) / max(n - 1, 1)

    stage_seconds["refinement_finalize"] = stage.seconds
    log.info("EigenSNP refinement + finalization done in %.1fs.",
             stage_seconds["refinement_finalize"])

    if diag is not None:
        diag["global"] = {
            "condensed_features": int(c_total),
            "k_global": int(k),
            "refine_passes": int(cfg.refine_passes),
            "refine_width": int(ell_ref),
            "sample_subset_size": int(len(subset)),
            "singular_values": np.asarray(sigma).tolist(),
            "final_eigenvalues": np.asarray(eigenvalues).tolist(),
            "condensed_spectrum": (condensed_spectrum.tolist()
                                   if condensed_spectrum is not None else []),
        }
        diag["refinement"] = {
            "passes_run": int(cfg.refine_passes),
            "subspace_residual_per_pass": refine_residuals,
        }
        diag["stage_seconds"] = {s: round(t, 3) for s, t in stage_seconds.items()}
        diag["num_pca_snps"] = int(d)
        diag["num_qc_samples"] = int(n)
        diag["num_ld_blocks"] = int(len(prep.blocks))
        diag["matrix_path"] = "device-resident" if use_device else "host-accessor"

    return EigenSnpResult(
        scores=scores,
        eigenvalues=eigenvalues,
        loadings=loadings,
        diagnostics=diag,
        stage_seconds={s: round(t, 3) for s, t in
                       {**prep.stage_seconds, **stage_seconds}.items()},
        container=container,
    )


def _sync(device: torch.device) -> None:
    """Wait for the device, so that a stage's wall clock holds its work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
