"""Sweep result analyzer: per-run metrics with caching + summary plots.

A copy of `genomic_pca_tpu/eval/sweep_analyze.py` (the reference's
tests/sweep_analyze.py) over the port's `eval/metrics.py`, run on a host
with pandas and scikit-learn; its pool workers start as plain processes
(the JAX copy strips a TPU grant's environment from them first):

* loads `sweeps_summary.tsv` (sweep_run output),
* computes population-structure metrics per run in a process pool with
  per-run cache files (`{pca-stem}.metrics_cache.tsv`,
  sweep_analyze.py:148-182),
* optionally injects an "Exact PCA Reference" row from the exact-PCA
  oracle output (sweep_analyze.py:236-248),
* emits per-parameter metric plots and a runtime-vs-parameter plot.
"""

from __future__ import annotations

import argparse
import logging
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

log = logging.getLogger(__name__)

METRIC_COLS = [
    "LogReg_Balanced_Accuracy_CV",
    "LogReg_Normalized_Accuracy_CV",
    "Mean_multivariate_Jensen_Shannon_divergence_nats",
    "Average_silhouette",
    "Mean_contrastive_violation",
    "HDBSCAN_adjusted_mutual_information",
]


def _metrics_for_pca_file(
    pca_file: str, sample_file: str, number_of_pcs: int
) -> Optional[pd.DataFrame]:
    """Compute (or load cached) per-superpopulation metrics for one run."""
    from genomic_pca_tpu_torch.eval.metrics import (
        compute_superpopulation_metrics,
        load_and_merge,
    )

    pca_path = Path(pca_file)
    cache = pca_path.with_name(pca_path.stem + ".metrics_cache.tsv")
    if cache.exists() and cache.stat().st_mtime >= pca_path.stat().st_mtime:
        return pd.read_csv(cache, sep="\t")
    try:
        merged, pc_cols = load_and_merge(pca_file, sample_file, number_of_pcs)
        df = compute_superpopulation_metrics(merged, pc_cols)
    except Exception as e:
        log.warning("Metrics failed for %s: %s", pca_file, e)
        return None
    df.to_csv(cache, sep="\t", index=False)
    return df


def _worker(args) -> Optional[Dict]:
    run_id, pca_file, sample_file, n_pcs = args
    df = _metrics_for_pca_file(pca_file, sample_file, n_pcs)
    if df is None:
        return None
    # aggregate across superpopulations (mean of available values)
    out = {"run_id": run_id}
    for col in METRIC_COLS:
        if col in df.columns:
            out[col] = float(pd.to_numeric(df[col], errors="coerce").mean())
    return out


def find_pca_file(run_dir: Path) -> Optional[Path]:
    hits = sorted(run_dir.glob("*.pca.tsv"))
    return hits[0] if hits else None


def analyze(
    sweep_dir: str,
    sample_file: str,
    number_of_pcs: int = 10,
    exact_pca_file: Optional[str] = None,
    jobs: int = 2,
    make_plots: bool = True,
) -> pd.DataFrame:
    base = Path(sweep_dir)
    summary = pd.read_csv(base / "sweeps_summary.tsv", sep="\t")

    work = []
    for _, row in summary.iterrows():
        run_dir = base / str(row["run_id"])
        pca = find_pca_file(run_dir)
        if pca is not None and bool(row["success"]):
            work.append((row["run_id"], str(pca), sample_file, number_of_pcs))

    results: List[Dict] = []
    if jobs > 1 and len(work) > 1:
        # spawn: the package imports torch, whose threads make fork unsafe.
        with ProcessPoolExecutor(jobs,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            for res in pool.map(_worker, work):
                if res:
                    results.append(res)
    else:
        for w in work:
            res = _worker(w)
            if res:
                results.append(res)

    if results:
        metrics_df = pd.DataFrame(results)
    else:
        log.warning("No run produced computable metrics.")
        metrics_df = pd.DataFrame(columns=["run_id"] + METRIC_COLS)
    merged = summary.merge(metrics_df, on="run_id", how="left")

    if exact_pca_file:
        ref = _worker(("Exact PCA Reference", exact_pca_file, sample_file, number_of_pcs))
        if ref:
            ref.update(
                swept_param_name="Exact PCA Reference",
                swept_param_value="N/A",
                duration_seconds=np.nan,
                success=True,
            )
            merged = pd.concat(
                [merged, pd.DataFrame([ref])], ignore_index=True
            )

    out_path = base / "sweep_metrics_summary.tsv"
    merged.to_csv(out_path, sep="\t", index=False)
    log.info("Wrote %s", out_path)

    if make_plots:
        _plot(merged, base)
    return merged


def _plot(merged: pd.DataFrame, base: Path) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    params = [
        p
        for p in merged["swept_param_name"].unique()
        if isinstance(p, str) and p.startswith("eigensnp_")
    ]
    ref_rows = merged[merged["swept_param_name"] == "Exact PCA Reference"]
    for metric in METRIC_COLS:
        if metric not in merged.columns:
            continue
        fig, axes = plt.subplots(
            max(1, -(-len(params) // 3)), 3, figsize=(15, 3.2 * max(1, -(-len(params) // 3))),
            squeeze=False,
        )
        for ax, param in zip(axes.flat, params):
            sub = merged[merged["swept_param_name"] == param]
            vals = pd.to_numeric(sub["swept_param_value"], errors="coerce")
            ax.plot(vals, sub[metric], "o-")
            if len(ref_rows) and not ref_rows[metric].isna().all():
                ax.axhline(
                    float(ref_rows[metric].iloc[0]), ls="--", color="gray",
                    label="exact PCA",
                )
                ax.legend(fontsize=6)
            ax.set_xlabel(param.replace("eigensnp_", ""))
            ax.set_xscale("symlog" if (vals.dropna() > 0).all() and vals.max() / max(vals.min(), 1e-12) > 100 else "linear")
        fig.suptitle(metric)
        fig.tight_layout()
        fig.savefig(base / f"sweep_{metric}.png", dpi=110)
        plt.close(fig)

    # runtime vs parameter mega-plot
    fig, axes = plt.subplots(
        max(1, -(-len(params) // 3)), 3, figsize=(15, 3.2 * max(1, -(-len(params) // 3))),
        squeeze=False,
    )
    for ax, param in zip(axes.flat, params):
        sub = merged[merged["swept_param_name"] == param]
        vals = pd.to_numeric(sub["swept_param_value"], errors="coerce")
        ax.plot(vals, sub["duration_seconds"], "s-", color="tab:red")
        ax.set_xlabel(param.replace("eigensnp_", ""))
        ax.set_ylabel("seconds")
    fig.suptitle("Runtime vs swept parameter")
    fig.tight_layout()
    fig.savefig(base / "sweep_runtime.png", dpi=110)
    plt.close(fig)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Analyze EigenSNP sweep results.")
    p.add_argument("--sweep-dir", required=True)
    p.add_argument("--sample-file", required=True)
    p.add_argument("--number-of-pcs", type=int, default=10)
    p.add_argument("--exact-pca-file", default=None)
    p.add_argument("--jobs", type=int, default=2)
    p.add_argument("--no-plots", action="store_true")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    analyze(
        args.sweep_dir,
        args.sample_file,
        args.number_of_pcs,
        args.exact_pca_file,
        args.jobs,
        make_plots=not args.no_plots,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
