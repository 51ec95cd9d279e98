"""The port's workflows: VCF -> randomized PCA, BED -> QC -> EigenSNP, and
the projection of new samples through a fitted model.

Counterparts of `genomic_pca_tpu/workflows.py` `run_vcf_workflow`,
`run_eigensnp_workflow` and `run_projection_workflow` on an explicit
`device`.  VCF parsing runs the per-file functions of the port's
`io/vcf.py` in this module's own spawn pool; outputs go through the
port's `io/writers.py` and are the reference's files.

In a process group of several ranks (parallel/mesh.py, one rank per
device) every rank runs the workflow: each rank parses only its own VCF
files (`load_vcf_directory_sharded`) or QCs only its own BIM range
(models/prepare.py), the matrix is split over the ranks, and rank 0
alone writes the outputs.  The projection workflow runs on one rank.
"""

from __future__ import annotations

import json
import logging
import multiprocessing as mp
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from genomic_pca_tpu_torch.config import DataPrepConfig, EigenSnpConfig, RsvdConfig
from genomic_pca_tpu_torch.errors import DataPrepError, VcfParseError
from genomic_pca_tpu_torch.io.bed import BedReader
from genomic_pca_tpu_torch.io.vcf import (
    discover_vcf_files, process_single_vcf, read_vcf_sample_names,
)
from genomic_pca_tpu_torch.io.writers import (
    read_loadings, read_moments, write_eigenvalues, write_loadings,
    write_principal_components,
)
from genomic_pca_tpu_torch.io.writers import write_moments as write_moments_tsv
from genomic_pca_tpu_torch.models.eigensnp import compute_eigensnp_pca
from genomic_pca_tpu_torch.models.pca import StripProjector, streamed_pca
from genomic_pca_tpu_torch.models.prepare import prepare_data
from genomic_pca_tpu_torch.ops import kernels
from genomic_pca_tpu_torch.ops.qc import (
    dosage_mean_from_counts, genotype_counts_int8_host,
)
from genomic_pca_tpu_torch.parallel import mesh
from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix, pack_int8_rows
from genomic_pca_tpu_torch.utils.system import preflight
from genomic_pca_tpu_torch.utils.timing import StageTimer

log = logging.getLogger(__name__)


def load_vcf_directory(
    vcf_dir: str, maf_threshold: Optional[float], n_workers: int = 0
) -> Tuple[List[str], List[str], List[np.ndarray]]:
    """(sample_names, variant_ids, dosage strips) of a whole VCF directory:
    `load_vcf_directory_sharded` on one rank, its files in sorted order."""
    canonical, _n_files, blocks = load_vcf_directory_sharded(
        vcf_dir, maf_threshold, rank=0, world=1, n_workers=n_workers)
    if not blocks:
        raise VcfParseError("No variants passed filters across all VCF files.")
    variant_ids = [vid for blk in blocks.values() for vid in blk.ids]
    return canonical, variant_ids, [blk.dosages for blk in blocks.values()]


def _parse_files(paths, canonical: List[str], maf_threshold: Optional[float],
                 n_workers: int) -> list:
    """`process_single_vcf` of each path, in order: in a spawn pool of up
    to `n_workers` processes with `n_workers > 1` and several files."""
    args = [(p, canonical, maf_threshold) for p in paths]
    if n_workers > 1 and len(paths) > 1:
        with mp.get_context("spawn").Pool(min(n_workers, len(paths))) as pool:
            return pool.starmap(process_single_vcf, args)
    return [process_single_vcf(*a) for a in args]


def load_vcf_directory_sharded(
    vcf_dir: str, maf_threshold: Optional[float], rank: int, world: int,
    n_workers: int = 0,
):
    """This rank's share of a VCF directory: the files i with i % world ==
    rank of the sorted list, as the JAX `load_vcf_directory_sharded`
    (genomic_pca_tpu/io/vcf.py:271-318).

    Returns (canonical samples, number of files, {file index: block}) for
    the owned files with surviving variants; a rank may own none.  Every
    rank reads the first file's header (the canonical sample set)."""
    paths = discover_vcf_files(vcf_dir)
    canonical = read_vcf_sample_names(paths[0])
    owned = [(i, p) for i, p in enumerate(paths) if i % world == rank]
    log.info("Rank %d/%d parsing %d of %d VCF files (%d canonical samples).",
             rank, world, len(owned), len(paths), len(canonical))
    parsed = _parse_files([p for _i, p in owned], canonical, maf_threshold,
                          n_workers)
    blocks = {i: blk for (i, _p), blk in zip(owned, parsed) if blk is not None}
    return canonical, len(paths), blocks


def _vcf_matrix(vcf_dir: str, maf: Optional[float], threads: int,
                device) -> Tuple[List[str], ShardedMatrix]:
    """The packed VCF matrix over the ranks of the process group (the JAX
    workflow's multi-process branch, genomic_pca_tpu/workflows.py:83-156):
    each rank parses its own files, the ranks exchange per-file variant
    counts, and each file becomes a unit of `from_owned_units` on the rank
    that parsed it, with center-only moments from exact histograms.  On
    one rank every file is rank 0's, placed in file order from row 0."""
    rank, world = mesh.process_index(), mesh.process_count()
    sample_names, n_files, owned = load_vcf_directory_sharded(
        vcf_dir, maf, rank, world, n_workers=threads)
    local_counts = np.zeros(n_files, dtype=np.int64)
    for fi, blk in owned.items():
        local_counts[fi] = blk.dosages.shape[0]
    counts = mesh.all_gather_numpy({"counts": local_counts})["counts"].sum(axis=0)
    if int(counts.sum()) == 0:
        raise VcfParseError("No variants passed filters across all VCF files.")
    local_units = {}
    for fi, blk in owned.items():
        g = np.asarray(blk.dosages, dtype=np.int8)
        m = dosage_mean_from_counts(genotype_counts_int8_host(g))
        local_units[fi] = (pack_int8_rows(g), m.astype(np.float32), None)
    matrix = ShardedMatrix.from_owned_units(
        counts, np.arange(n_files, dtype=np.int64) % world, local_units,
        n_samples=len(sample_names), device=device, packed=True,
        center_only=True,
    )
    return sample_names, matrix


def run_vcf_workflow(
    vcf_dir: str,
    output_prefix: str,
    k: int,
    maf: Optional[float] = None,
    rfit_seed: Optional[int] = None,
    rfit_tolerance: Optional[float] = None,
    threads: int = 0,
    write_real_eigenvalues: bool = True,
    device="cuda",
) -> None:
    """VCF directory -> packed device matrix -> randomized PCA -> TSVs.

    Moments are center-without-scale (std = 1), as in the reference VCF
    workflow; eigenvalues.tsv holds the explained variances unless
    `write_real_eigenvalues=False`.  In a process group of several ranks
    each rank parses and holds its own files (`_vcf_matrix`) and rank 0
    writes the outputs."""
    timer = StageTimer()
    preflight(planned_threads=threads)
    with timer.stage("VCF parsing & matrix assembly"):
        sample_names, matrix = _vcf_matrix(vcf_dir, maf, threads, device)
    log.info(
        "Assembled %d variants x %d samples (%d packed bytes per row) on %s "
        "(device-resident container, %s mode, %d rows on each of %d ranks).",
        matrix.n_rows, matrix.n_samples, matrix.geno.shape[1], matrix.device,
        matrix.mode, matrix.d_pad, matrix.world,
    )

    with timer.stage("Randomized PCA (rfit)"):
        rs = RsvdConfig(k=k, seed=rfit_seed, tolerance=rfit_tolerance)
        result = streamed_pca(
            matrix,
            k=rs.k,
            n_oversamples=rs.n_oversamples,
            n_power_iter=rs.n_power_iter,
            seed=rs.seed,
            tolerance=rs.tolerance,
        )

    with timer.stage("Output writing"):
        if mesh.process_index() == 0:
            write_principal_components(
                output_prefix, sample_names, result.scores, suffix="vcf.pca.tsv"
            )
            write_eigenvalues(
                output_prefix, result.eigenvalues if write_real_eigenvalues else []
            )

    timer.log_summary("VCF workflow stage timings")
    log.info("Kernel launches: %s", json.dumps(kernels.LAUNCHES))


def run_eigensnp_workflow(
    prep_config: DataPrepConfig,
    algo_config: EigenSnpConfig,
    output_prefix: str,
    checkpoint_dir: Optional[str] = None,
    write_moments: bool = False,
    stop_after_checkpoint: Optional[str] = None,
    device="cuda",
    force_streaming: bool = False,
) -> None:
    """BED + LD blocks -> QC -> two-stage EigenSNP PCA -> TSVs.

    Writes `{prefix}.eigensnp.pca.tsv`, `{prefix}.eigenvalues.tsv`,
    `{prefix}.eigensnp.loadings.tsv`, with `write_moments`
    `{prefix}.eigensnp.moments.tsv`, and with diagnostics
    `{prefix}.eigensnp_diagnostics.json`.  A run stopped after a
    checkpoint writes nothing.  `force_streaming` takes the host-streamed
    container whatever the memory budget (no CLI flag, as in the JAX
    CLI).  Logs the container that ran, the stage split on one line at
    the end (QC + LD mapping, matrix load, stages 1-2, global PCA,
    refinement + write) and the kernel launches.  In a process group of
    several ranks every rank runs it (distributed QC, one matrix unit a
    rank) and rank 0 writes the outputs."""
    timer = StageTimer()
    preflight(planned_threads=16)
    with timer.stage("Data preparation (QC + LD mapping)"):
        prep = prepare_data(prep_config, device=device)

    with timer.stage("EigenSNP core algorithm"):
        result = compute_eigensnp_pca(
            prep, algo_config, device=device, checkpoint_dir=checkpoint_dir,
            stop_after_checkpoint=stop_after_checkpoint,
            force_streaming=force_streaming,
        )
    if result is None:
        timer.log_summary("EigenSNP partial-run stage timings (stopped after "
                          f"checkpoint {stop_after_checkpoint!r})")
        return

    with timer.stage("Output writing"):
        if mesh.process_index() == 0:
            _write_eigensnp_outputs(prep, result, output_prefix, write_moments)

    timer.log_summary("EigenSNP workflow stage timings")
    log.info("EigenSNP matrix container: %s.", result.container)
    st, ss = timer.stages, result.stage_seconds
    log.info(
        "EigenSNP stage split: qc_ld %.3f s, matrix_load %.3f s, stages_1_2 "
        "%.3f s, global_pca %.3f s, refine_write %.3f s",
        st["Data preparation (QC + LD mapping)"], ss["matrix_load"],
        ss["stages_1_2"], ss["global_pca"],
        ss["refinement_finalize"] + st["Output writing"],
    )
    log.info("Kernel launches: %s", json.dumps(kernels.LAUNCHES))


def _write_eigensnp_outputs(prep, result, output_prefix: str,
                            write_moments: bool) -> None:
    """The EigenSNP workflow's TSVs (and diagnostics JSON)."""
    write_principal_components(output_prefix, prep.sample_ids, result.scores,
                               suffix="eigensnp.pca.tsv")
    write_eigenvalues(output_prefix, result.eigenvalues)
    sids, chroms, positions = prep.snp_metadata()
    write_loadings(output_prefix, [str(s) for s in sids],
                   [str(c) for c in chroms], [int(p) for p in positions],
                   result.loadings)
    if write_moments:
        idx = prep.pca_snp_orig_indices
        write_moments_tsv(output_prefix, [str(s) for s in sids], prep.mean,
                          prep.std, [str(x) for x in prep.bed.bim.a1[idx]],
                          [str(x) for x in prep.bed.bim.a2[idx]])
    if result.diagnostics is not None:
        path = f"{output_prefix}.eigensnp_diagnostics.json"
        with open(path, "w") as fh:
            json.dump(result.diagnostics, fh, indent=2)
        log.info("Wrote diagnostics to %s", path)


def _model_rows(bed: BedReader, bed_path: str, l_ids: List[str],
                m_a1: List[str], m_a2: List[str]) -> np.ndarray:
    """BIM rows of the model's SNPs, matched by VariantID; raises
    DataPrepError for duplicated, absent or allele-swapped SNPs."""
    counts = Counter(bed.bim.sid)
    dups = [vid for vid in l_ids if counts.get(vid, 0) > 1]
    if dups:
        raise DataPrepError(
            f"{len(dups)} model SNPs appear more than once in "
            f"{bed_path}'s BIM (first: {dups[:3]}); VariantID matching "
            "is ambiguous — deduplicate the new fileset first."
        )
    pos_of = {sid: i for i, sid in enumerate(bed.bim.sid)}
    missing = [vid for vid in l_ids if vid not in pos_of]
    if missing:
        raise DataPrepError(
            f"{len(missing)} / {len(l_ids)} model SNPs absent from "
            f"{bed_path} (first: {missing[:3]}); projection requires "
            "every fitted SNP in the new fileset."
        )
    rows = np.asarray([pos_of[vid] for vid in l_ids], dtype=np.int64)
    # A swapped A1/A2 encodes dosage' = 2 - dosage: projecting through it
    # would silently flip the SNP's contribution.
    new_a1, new_a2 = bed.bim.a1[rows], bed.bim.a2[rows]
    bad = [l_ids[j] for j in range(len(l_ids))
           if str(new_a1[j]) != m_a1[j] or str(new_a2[j]) != m_a2[j]]
    if bad:
        raise DataPrepError(
            f"{len(bad)} model SNPs have a different A1/A2 "
            f"orientation in {bed_path} (first: {bad[:3]}); harmonize "
            "alleles (swap/flip) before projecting — a swapped "
            "orientation encodes dosage' = 2 - dosage and would "
            "corrupt the scores silently."
        )
    return rows


def run_projection_workflow(
    bed_path: str,
    loadings_path: str,
    moments_path: str,
    output_prefix: str,
    projection_strip_rows: int = 262_144,
    projection_strip_bytes: int = 1 << 29,
    device="cuda",
) -> None:
    """Project the samples of a PLINK fileset into a fitted PC space.

    Loads the fitted loadings and training moments TSVs, matches the
    model's SNPs in the new fileset by VariantID (duplicated, absent and
    allele-swapped SNPs raise DataPrepError), and sums per-strip
    projections (`StripProjector`) over strips bounded by
    `projection_strip_rows` and by `projection_strip_bytes` of decoded
    int8, the next strip decoding on a background thread.  Missing
    genotypes impute to the training mean.  Writes
    `{prefix}.projected.pca.tsv`.  Runs on one rank: in a process group
    of several it raises DataPrepError, as the JAX workflow does."""
    if mesh.process_count() > 1:
        raise DataPrepError(
            "--project is a single-process operation (the model is k "
            "columns; there is nothing to shard across hosts) — run it on "
            "one process."
        )
    timer = StageTimer()
    with timer.stage("Model loading (loadings + moments)"):
        l_ids, loadings = read_loadings(loadings_path)
        m_ids, m_a1, m_a2, means, stds = read_moments(moments_path)
        if l_ids != m_ids:
            raise DataPrepError(
                "Loadings and moments TSVs disagree on the SNP set "
                f"({len(l_ids)} vs {len(m_ids)} variants or different "
                "order); both must come from the same fit."
            )

    with timer.stage("New-sample genotype matching"):
        bed = BedReader(bed_path)
        rows = _model_rows(bed, bed_path, l_ids, m_a1, m_a2)

    with timer.stage("Device projection (strip-chunked)"):
        n_new = bed.n_samples
        all_samples = np.arange(n_new, dtype=np.int64)
        scores = np.zeros((n_new, loadings.shape[1]), dtype=np.float32)
        strip = max(1024, min(projection_strip_rows,
                              projection_strip_bytes // max(n_new, 1)))
        bounds = [(lo, min(lo + strip, len(rows)))
                  for lo in range(0, len(rows), strip)]
        project = StripProjector(strip, n_new, loadings.shape[1], device=device)
        with ThreadPoolExecutor(1) as ex:
            nxt = ex.submit(bed.read, rows[bounds[0][0]:bounds[0][1]], all_samples)
            for i, (lo, hi) in enumerate(bounds):
                g_strip = nxt.result()
                if i + 1 < len(bounds):
                    lo2, hi2 = bounds[i + 1]
                    nxt = ex.submit(bed.read, rows[lo2:hi2], all_samples)
                scores += project(g_strip, loadings[lo:hi], means[lo:hi],
                                  stds[lo:hi])

    with timer.stage("Output writing"):
        write_principal_components(output_prefix, list(bed.fam.iid), scores,
                                   suffix="projected.pca.tsv")
    timer.log_summary("Projection workflow stage timings")
