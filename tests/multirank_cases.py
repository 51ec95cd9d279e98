"""Jax-free rank workers of the multi-rank tests.

Each function runs on every rank spawned by
`genomic_pca_tpu_torch.eval.multichip.run_ranks` (a gloo process group on
the CPU), so it must stay importable without jax: the ranks import this
module, never tests/conftest.py.
"""

import numpy as np
import torch

from genomic_pca_tpu_torch.models.pca import pca_core, power_iterate
from genomic_pca_tpu_torch.parallel import mesh
from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix


def container(spec) -> ShardedMatrix:
    """This rank's shard of the reference arrays in `spec`."""
    return ShardedMatrix.from_reference_arrays(
        spec["geno"], spec["mean"], spec["inv_std"], spec["n_rows"],
        spec["n_samples"], "cpu", **spec.get("kw", {}))


def passes(sm: ShardedMatrix, spec) -> dict:
    """Every pass of `sm` on the bases of `spec`, plus the power loop with
    and without a tolerance and the whole PCA where `spec` has `b0`."""
    b = torch.from_numpy(spec["b"])
    mesh.reset_collective_counts()
    out = {"gram": sm.gram_apply(b).numpy()}
    out["gram_collectives"] = dict(mesh.COLLECTIVES)
    out["tsq"] = sm.tsq_accumulate(b).numpy()
    out["right"] = sm.right_apply(b)
    out["left"] = sm.left_apply(spec["w"])
    out["count_missing"] = sm.count_missing()
    out["layout"] = (sm.rank, sm.world, sm.row_offset, sm.d_pad)
    if "b0" in spec:
        b0 = torch.from_numpy(spec["b0"])
        out["q"] = power_iterate(sm, b0, 4)[0].numpy()
        v, s, e, load, _ = pca_core(sm, b0, 4, 3)
        out["pca_core"] = (v.numpy(), s.numpy(), e.numpy(), load)
        out["n_done"] = {tol: power_iterate(sm, b0, 6, tolerance=tol)[1]
                         for tol in spec.get("tolerances", ())}
    return out


def reference_worker(spec) -> dict:
    """`passes` of this rank's shard of the reference arrays."""
    return passes(container(spec), spec)


def reference_list_worker(specs) -> list:
    """`reference_worker` of each spec, in one process group."""
    return [reference_worker(spec) for spec in specs]


def foreign_unit_worker(_spec=None) -> None:
    """Rank 1 supplies unit 0, which rank 0 owns: must raise."""
    g = np.zeros((3, 2), np.uint8)
    local = {0: (g, np.zeros(3), np.ones(3))} if mesh.process_index() == 1 else {}
    ShardedMatrix.from_owned_units([3], [0], local, 8, "cpu", packed=True)


def segments_worker(spec) -> dict:
    """Row-layout queries, block slices and `passes` of this rank's
    shard."""
    sm = container(spec)
    runs = spec["runs"]
    out = passes(sm, spec)
    out["sliceable"] = sm.runs_device_sliceable(runs)
    if out["sliceable"]:
        owner = sm.rank_of_runs(runs)
        mine = np.nonzero(owner == sm.rank)[0]
        out["owner"] = owner
        out["mine"] = mine
        if len(mine):
            out["blocks"] = sm.fetch_blocks_device(
                runs[mine, 0], runs[mine, 1], spec["bucket"]).numpy()
    out["local_runs"] = sm._local_runs()
    return out


def owned_units_worker(spec) -> dict:
    """`from_owned_units` of this rank's units of `spec["units"]`, packed,
    and `passes` of it."""
    rank = mesh.process_index()
    local = {u: spec["units"][u] for u, owner in enumerate(spec["owner"])
             if owner == rank}
    sm = ShardedMatrix.from_owned_units(
        [len(spec["units"][u][0]) for u in range(len(spec["owner"]))],
        spec["owner"], local, spec["n_samples"], "cpu", tile_d=spec["tile_d"],
        packed=True, kernel_precision="f32", mode=spec["mode"])
    out = passes(sm, spec)
    out["row_segments"] = sm.row_segments
    return out


def local_rows_worker(spec) -> dict:
    """`from_local_rows` over the packed rows of `spec`, and `passes`."""
    g, m, s = spec["packed"], spec["mean"], spec["std"]
    seen = []

    def read(lo, hi):
        seen.append((lo, hi))
        return g[lo:hi], m[lo:hi], s[lo:hi]

    sm = ShardedMatrix.from_local_rows(read, len(g), spec["n_samples"], "cpu",
                                       tile_d=spec["tile_d"], packed=True,
                                       kernel_precision="f32", mode=spec["mode"])
    out = passes(sm, spec)
    out["read"] = seen
    return out


def local_rows_list_worker(specs) -> list:
    """`local_rows_worker` of each spec, in one process group."""
    return [local_rows_worker(spec) for spec in specs]


def prepare_worker(config) -> dict:
    """`prepare_data` of `config` on this rank: the merged QC."""
    from genomic_pca_tpu_torch.models.prepare import prepare_data

    prep = prepare_data(config, device="cpu")
    return {"pca": prep.pca_snp_orig_indices, "mean": prep.mean, "std": prep.std,
            "n_post_qc": prep.n_snps_post_qc, "scan_ranges": prep.scan_ranges}


def projection_worker(args) -> None:
    from genomic_pca_tpu_torch.workflows import run_projection_workflow

    run_projection_workflow(*args, device="cpu")


def collectives_worker(_spec=None) -> dict:
    """The mesh functions on this rank's values."""
    rank = mesh.process_index()
    summed = mesh.all_reduce_sum(torch.full((2, 3), float(rank + 1))).numpy()
    rows = mesh.all_gather_rows(torch.full((2, 1), float(rank))).numpy()
    tree = mesh.all_gather_numpy({"i": np.arange(3) + 10 * rank,
                                  "b": np.array([rank % 2 == 0, True])})
    objs = mesh.all_gather_object({"rank": rank, "shape": (rank, 2)})
    return {"summed": summed, "rows": rows, "tree": tree,
            "objs": objs,
            "world": mesh.process_count(), "rank": rank}


def checkpoint_view_worker(dirs) -> dict:
    """EigenSNP's checkpoint probes on this rank's directory `dirs[rank]`:
    rank 0 writes stage "s" there, no other rank sees it."""
    from genomic_pca_tpu_torch.models import eigensnp
    from genomic_pca_tpu_torch.utils.checkpoint import StageCheckpointer

    rank = mesh.process_index()
    ckpt = StageCheckpointer(dirs[rank], "fp")
    if rank == 0:
        ckpt.save("s", {"x": np.arange(3)})
    mesh.barrier()
    return {"own": ckpt.has("s"), "agreed": eigensnp._has(ckpt, "s"),
            "absent": eigensnp._has(ckpt, "t")}


def streamed_passes(sm, spec) -> dict:
    """Every pass of the host-streamed container `sm` on the bases of
    `spec`, with the strips this rank streamed and the collectives of one
    gram pass."""
    b = torch.from_numpy(spec["b"])
    mesh.reset_collective_counts()
    out = {"gram": sm.gram_apply(b).numpy()}
    out["gram_collectives"] = dict(mesh.COLLECTIVES)
    out["tsq"] = sm.tsq_accumulate(b).numpy()
    out["right"] = sm.right_apply(b)
    acc, project = sm.tsq_and_project(b)
    out["tsq_project"], out["project"] = acc.numpy(), project(spec["w"])
    acc, ab = sm._tsq_and_capture(b)
    out["tsq_capture"], out["capture"] = acc.numpy(), ab
    out["own_strips"] = sm.own_strips
    out["strips_seen"] = [t["strips"] for t in sm.pass_log]
    return out


def streaming_worker(config) -> dict:
    """`streamed_passes` of the host-streamed container of `config` on
    this rank, over strips of 64 rows."""
    from genomic_pca_tpu_torch.models.prepare import prepare_data

    prep = prepare_data(config, device="cpu")
    sm = prep.load_streaming_matrix("cpu", strip_size=64, kernel_precision="f32")
    rng = np.random.default_rng(3)
    spec = {"b": rng.standard_normal((prep.n_samples, 5)).astype(np.float32),
            "w": rng.standard_normal((5, 2)).astype(np.float32)}
    return streamed_passes(sm, spec)


def strips_worker(specs) -> list:
    """For each spec: a host-streamed container over the host strips of
    `spec["geno"]` (`spec["strip"]` rows, packed or int8 dosages),
    `streamed_passes` in f32, the q8 pass and the q8 power loop with and
    without a tolerance."""
    from genomic_pca_tpu_torch.ops.streaming import StreamingMatrix

    outs = []
    for spec in specs:
        g, mean, std, strip = spec["geno"], spec["mean"], spec["std"], spec["strip"]

        def source(i, g=g, mean=mean, std=std, strip=strip):
            return g[i * strip:(i + 1) * strip], mean[i * strip:(i + 1) * strip], \
                std[i * strip:(i + 1) * strip]

        def container(precision):
            return StreamingMatrix(
                source, -(-spec["n_rows"] // strip), spec["n_rows"], spec["n_samples"],
                strip, packed=spec["packed"], mode="1d", kernel_precision=precision,
                tile_d=spec["tile_d"], device="cpu")

        out = streamed_passes(container("f32"), spec)
        q8 = container("q8")
        b0 = torch.from_numpy(spec["b0"])
        out["q8"] = q8.q8_pass(torch.from_numpy(spec["b"])).numpy()
        out["q"] = power_iterate(q8, b0, 4)[0].numpy()
        out["n_done"] = {tol: power_iterate(q8, b0, 6, tolerance=tol)[1]
                         for tol in (10.0, 0.0)}
        outs.append(out)
    return outs


def capture_worker(configs) -> list:
    """For each config: this rank's resident container built from its QC
    capture (`qc_mode="device"`) and from its host scan and a BED re-read
    (`qc_mode="host"`)."""
    import dataclasses

    from genomic_pca_tpu_torch.models.prepare import prepare_data

    outs = []
    for config in configs:
        out = {}
        for mode in ("device", "host"):
            prep = prepare_data(dataclasses.replace(config, qc_mode=mode), device="cpu")
            out[f"captured_{mode}"] = prep.qc_capture is not None
            sm = prep.load_matrix("cpu")
            out[mode] = {"geno": sm.geno.numpy(), "mean": sm.mean.numpy(),
                         "inv_std": sm.inv_std.numpy(), "n_rows": sm.n_rows,
                         "row_segments": sm.row_segments, "pca": prep.pca_snp_orig_indices}
        outs.append(out)
    return outs


def empty_rank_worker(spec) -> dict:
    """Every unit on rank 0: what the other ranks hold and contribute
    before the merge (the 1-D gram and q8 passes' local outputs)."""
    from genomic_pca_tpu_torch.ops.rsvd import quantize_basis

    rank = mesh.process_index()
    local = {0: spec["unit"]} if rank == 0 else {}
    sm = ShardedMatrix.from_owned_units([len(spec["unit"][0])], [0], local,
                                        spec["n_samples"], "cpu", tile_d=64,
                                        packed=True, mode="1d")
    bp = sm.basis(torch.from_numpy(spec["b"]))
    args = (sm.geno, sm.mean, sm.inv_std)
    gram = sm._k1d[0](*args, bp, "bf16")
    bq, sb, csum = quantize_basis(bp)
    out, ru = sm._k1d[3](sm.geno, sm.inv_std, sm._u, bq, sb, csum, tile_d=64)
    return {"d_pad": sm.d_pad, "gram_zero": bool((gram == 0).all()),
            "q8_zero": bool(((out - ru) == 0).all()),
            "gram": sm.gram_apply(torch.from_numpy(spec["b"])).numpy()}


def whole_matrix_worker(_spec=None) -> None:
    """A whole-matrix constructor under a process group: must raise."""
    g = np.zeros((3, 2), np.uint8)
    ShardedMatrix.from_packed_rows(g, np.zeros(3), np.ones(3), 8, "cpu")
