"""The randomized PCA job (rfit) on a resident container.

Set-up makes the cohort on the device and builds the program's resident
container from it, strip by strip, through `ShardedMatrix
.from_owned_units` with a device reader: each rank makes and holds only
its own rows (one unit a rank).  The moments are mean and sample std
(`moments: standardized`, as the EigenSNP container standardizes) or the
mean with std 1 (`moments: centered`, as the VCF workflow's rfit does).
A job is one `models.pca.streamed_pca` call with the configuration's k,
oversampling and power iterations and the job's seed.
"""

from __future__ import annotations

import torch

from benchmark import generate
from benchmark.reference import compare, decode, pca

def rank_rows(n_rows: int, strip_rows: int, world: int):
    """Each rank's rows [lo, hi): equal shares rounded up to whole
    strips, so every rank starts on the generator's strip grid."""
    share = -(-n_rows // world)
    per = -(-share // strip_rows) * strip_rows
    return [(min(r * per, n_rows), min((r + 1) * per, n_rows)) for r in range(world)]


def _seed(state, index: int) -> int:
    return state["seed"] + index + 1


def setup(ctx) -> dict:
    from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix

    cfg, traffic = ctx.config, ctx.traffic
    d, n = cfg["sizes"]["n_snps"], cfg["sizes"]["n_samples"]
    strip = generate.strip_rows_for(n)
    ranges = rank_rows(d, strip, ctx.world)
    lo, hi = ranges[ctx.rank]
    cohort = generate.make_cohort(cfg["model"], d, n, ctx.seed, ctx.device, lo, hi)
    centered = traffic["moments"] == "centered"
    mean, std = generate.moments(cohort)
    sm = ShardedMatrix.from_owned_units(
        [h - l for l, h in ranges], list(range(ctx.world)),
        {ctx.rank: (lambda a, b: generate.packed_strip(cohort, a, b), mean,
                    None if centered else std)},
        n_samples=n, device=ctx.device, packed=True, center_only=centered,
        strip_rows=strip)
    return {"cohort": cohort, "matrix": sm, "seed": ctx.seed, "ctx": ctx,
            "centered": centered}


def run(state, index: int) -> dict:
    from genomic_pca_tpu_torch.models.pca import streamed_pca

    p = state["ctx"].config["pca"]
    res = streamed_pca(state["matrix"], k=p["k"], n_oversamples=p["n_oversamples"],
                       n_power_iter=p["n_power_iter"], seed=_seed(state, index))
    return {"scores": res.scores, "evals": res.eigenvalues}


def release(state) -> None:
    state.pop("matrix", None)


def _blocks(state, dtype):
    """(blocks, device): the cohort's rows standardized with the
    reference's own moments, strips grouped into blocks of about
    `pca.BLOCK_ELEMS` genotypes so that each product has rows enough to
    fill the card."""
    cohort = state["cohort"]
    n, dev = cohort.n_samples, cohort.freqs.device
    packed = [generate.packed_strip(cohort, lo, hi) for lo, hi in cohort.strips()]
    cnt = torch.cat([decode.counts(decode.codes(p, n)) for p in packed]
                    or [torch.zeros((0, 4), dtype=torch.int64, device=dev)])
    mean, std = decode.moments(cnt)
    std = None if state["centered"] else std
    group = max(1, pca.BLOCK_ELEMS // max(cohort.strip_rows * n, 1))

    def blocks():
        lo = 0
        for i in range(0, len(packed), group):
            p = torch.cat(packed[i:i + group])
            r = p.shape[0]
            yield decode.standardized(p, n, mean[lo:lo + r],
                                      None if std is None else std[lo:lo + r], dtype)
            lo += r
    return blocks, dev


def reference(state, rounding=None, n_iter=None, ell=None, seed=0):
    """The reference's (V, eigenvalues) of the cohort's matrix, with its
    own moments.  Defaults give the converged reference; `rounding`,
    `n_iter` and `ell` put it in the program's place (the control)."""
    ctx, n = state["ctx"], state["cohort"].n_samples
    exact = pca.exact(n) and n_iter is None
    blocks, dev = _blocks(state, torch.float64 if exact else torch.float32)
    return pca.solve(blocks, n, ctx.config["pca"]["k"], dev, ctx.all_reduce, seed,
                     rounding, n_iter, ell)


def check(state, records) -> list:
    """Per job: `pc_err`, the larger of `score_sin` and `eval_err`
    (reported beside it), against the converged reference, and
    `ritz_err` over all k PCs, against the data."""
    ctx = state["ctx"]
    k, n = ctx.config["pca"]["k"], state["cohort"].n_samples
    if "reference" not in state:
        v, ev = reference(state)
        state["reference"] = v.cpu().numpy(), ev.cpu().numpy()
    v, ev = state["reference"]
    m = compare.separated_prefix(ev, k)
    if m == 0:
        raise RuntimeError("the reference spectrum has no gap among the first "
                           f"{k} PCs: nothing to compare")
    blocks, dev = _blocks(state, torch.float64 if pca.exact(n) else torch.float32)
    sums = pca.ritz_sums(blocks, [(r["scores"], r["evals"]) for r in records], n, dev,
                         ctx.all_reduce)
    out = []
    for r, s in zip(records, sums):
        got = compare.pca_numbers(r["scores"], r["evals"], v, ev, m)
        got["pc_err"] = max(got.values())
        got.update(compare.ritz_numbers(r["evals"], s))
        got["pcs"] = m
        out.append(got)
    return out


def control(state, seed: int, rounding) -> dict:
    """The reference put in the program's place, its operands rounded to
    `rounding`: the job's k, sketch width (lane-filled to 128 columns, as
    the program fills it) and power iterations."""
    p = state["ctx"].config["pca"]
    n, d = state["cohort"].n_samples, state["cohort"].n_rows
    ell = min(max(-(-(p["k"] + p["n_oversamples"]) // 128) * 128,
                  p["k"] + p["n_oversamples"]), n, d)
    v, ev = reference(state, rounding=rounding, n_iter=p["n_power_iter"], ell=ell,
                      seed=seed)
    v, ev = v[:, :p["k"]], ev[:p["k"]]
    sigma = torch.sqrt(ev * max(n - 1, 1))
    return {"scores": (v * sigma[None, :]).cpu().numpy(), "evals": ev.cpu().numpy()}
