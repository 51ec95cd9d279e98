"""Visualization harness for PCA outputs.

A copy of `genomic_pca_tpu/eval/plot.py` (the reference's tests/plot.py)
over the port's `eval/metrics.py`, run on a host with pandas and
matplotlib: discovers outputs by the
filename-suffix convention (`*.pca.tsv`, `*.eigenvalues.tsv`,
`*.loadings.tsv` — plot.py:16-18) and produces:

* scree + cumulative-variance plot,
* PC scatter pairs colored by subpopulation with per-superpopulation
  KDE contours,
* loadings-vs-position 2D histograms,
* UMAP embedding of all PCs (only if the optional `umap-learn` package
  is installed — gated, not required),
* an HSV-derived per-subpopulation color system with legend
  (plot.py:29-383 behaviors).
"""

from __future__ import annotations

import argparse
import colorsys
import logging
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

log = logging.getLogger(__name__)

SUPERPOP_BASE_HUES = {
    "AFR": 0.04,
    "AMR": 0.75,
    "EAS": 0.33,
    "EUR": 0.60,
    "SAS": 0.12,
}


def population_colors(
    subpops_by_superpop: Dict[str, List[str]]
) -> Dict[str, tuple]:
    """HSV-derived color per subpopulation, hue-grouped by superpop."""
    colors = {}
    for spop, subs in subpops_by_superpop.items():
        base = SUPERPOP_BASE_HUES.get(spop, 0.85)
        for i, sub in enumerate(sorted(subs)):
            hue = (base + 0.05 * (i / max(len(subs), 1))) % 1.0
            sat = 0.55 + 0.4 * ((i % 3) / 2)
            val = 0.65 + 0.3 * (((i + 1) % 2))
            colors[sub] = colorsys.hsv_to_rgb(hue, sat, min(val, 0.95))
    return colors


def find_outputs(directory: str):
    """Locate outputs by suffix convention (plot.py:16-18)."""
    d = Path(directory)
    pca = sorted(d.glob("*.pca.tsv"))
    evals = sorted(d.glob("*.eigenvalues.tsv"))
    loadings = sorted(d.glob("*.loadings.tsv"))
    return (
        pca[0] if pca else None,
        evals[0] if evals else None,
        loadings[0] if loadings else None,
    )


def plot_scree(eigenvalues: np.ndarray, out_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    k = len(eigenvalues)
    frac = eigenvalues / eigenvalues.sum() if eigenvalues.sum() > 0 else eigenvalues
    fig, ax1 = plt.subplots(figsize=(8, 5))
    ax1.plot(range(1, k + 1), eigenvalues, "o-", label="eigenvalue")
    ax1.set_xlabel("PC")
    ax1.set_ylabel("Eigenvalue")
    ax2 = ax1.twinx()
    ax2.plot(range(1, k + 1), np.cumsum(frac), "s--", color="tab:orange")
    ax2.set_ylabel("Cumulative variance fraction")
    ax1.set_title("Scree plot")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_pc_scatters(
    merged: pd.DataFrame,
    pc_cols: List[str],
    out_path: str,
    max_pairs: int = 4,
    kde_contours: bool = True,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    by_spop: Dict[str, List[str]] = {}
    for spop, sub in zip(
        merged["Superpopulation code"], merged["Population code"]
    ):
        by_spop.setdefault(spop, [])
        if sub not in by_spop[spop]:
            by_spop[spop].append(sub)
    colors = population_colors(by_spop)

    pairs = [
        (pc_cols[i], pc_cols[i + 1])
        for i in range(0, min(len(pc_cols) - 1, max_pairs * 2), 2)
    ][:max_pairs]
    if not pairs:
        pairs = [(pc_cols[0], pc_cols[0])]
    ncols = min(2, len(pairs))
    nrows = -(-len(pairs) // ncols)
    fig, axes = plt.subplots(
        nrows, ncols, figsize=(7 * ncols, 6 * nrows), squeeze=False
    )
    for ax, (cx, cy) in zip(axes.flat, pairs):
        for sub, grp in merged.groupby("Population code"):
            ax.scatter(
                grp[cx], grp[cy], s=8, alpha=0.7,
                color=colors.get(sub, (0.4, 0.4, 0.4)), label=sub,
            )
        if kde_contours:
            try:
                from scipy.stats import gaussian_kde

                for spop, grp in merged.groupby("Superpopulation code"):
                    if len(grp) < 5:
                        continue
                    xy = grp[[cx, cy]].to_numpy().T
                    kde = gaussian_kde(xy)
                    xg = np.linspace(*ax.get_xlim(), 60)
                    yg = np.linspace(*ax.get_ylim(), 60)
                    xx, yy = np.meshgrid(xg, yg)
                    zz = kde(np.vstack([xx.ravel(), yy.ravel()])).reshape(xx.shape)
                    ax.contour(xx, yy, zz, levels=3, linewidths=0.7, alpha=0.5)
            except Exception:  # singular KDE etc. — contours are cosmetic
                pass
        ax.set_xlabel(cx)
        ax.set_ylabel(cy)
    handles, labels = axes.flat[0].get_legend_handles_labels()
    fig.legend(handles, labels, loc="center right", fontsize=7)
    fig.tight_layout(rect=(0, 0, 0.92, 1))
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_loadings_density(
    loadings_df: pd.DataFrame, out_path: str, max_pcs: int = 4
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pc_cols = [c for c in loadings_df.columns if c.endswith("_loading")][:max_pcs]
    if not pc_cols or "Pos" not in loadings_df.columns:
        return
    fig, axes = plt.subplots(
        len(pc_cols), 1, figsize=(10, 2.6 * len(pc_cols)), squeeze=False
    )
    for ax, col in zip(axes.flat, pc_cols):
        ax.hist2d(
            loadings_df["Pos"], loadings_df[col], bins=(200, 60), cmap="viridis"
        )
        ax.set_ylabel(col)
    axes.flat[-1].set_xlabel("Position (bp)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def plot_umap(merged: pd.DataFrame, pc_cols: List[str], out_path: str) -> bool:
    """UMAP of all PCs; returns False if umap-learn is unavailable."""
    try:
        import umap  # type: ignore
    except ImportError:
        log.info("umap-learn not installed; skipping UMAP plot.")
        return False
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    emb = umap.UMAP(random_state=42).fit_transform(merged[pc_cols].to_numpy())
    fig, ax = plt.subplots(figsize=(8, 7))
    for sub, grp in merged.groupby("Population code"):
        idx = merged.index.get_indexer(grp.index)
        ax.scatter(emb[idx, 0], emb[idx, 1], s=8, alpha=0.7, label=sub)
    ax.set_title("UMAP of PC scores")
    ax.legend(fontsize=6)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return True


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Plot PCA outputs.")
    p.add_argument("--results-dir", required=True,
                   help="Directory containing *.pca.tsv / *.eigenvalues.tsv "
                        "/ *.loadings.tsv outputs.")
    p.add_argument("--sample-file", default=None,
                   help="igsr-style sample table for population coloring.")
    p.add_argument("--out-dir", default=None)
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    pca_path, ev_path, load_path = find_outputs(args.results_dir)
    out_dir = Path(args.out_dir or args.results_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if ev_path is not None:
        ev = pd.read_csv(ev_path, sep="\t")
        if len(ev):
            plot_scree(ev["Eigenvalue"].to_numpy(), str(out_dir / "scree.png"))
            log.info("Wrote scree.png")

    if pca_path is not None and args.sample_file:
        from genomic_pca_tpu_torch.eval.metrics import load_and_merge

        pca_df = pd.read_csv(pca_path, sep="\t")
        n_pcs = sum(1 for c in pca_df.columns if c.startswith("PC"))
        merged, pc_cols = load_and_merge(
            str(pca_path), args.sample_file, n_pcs
        )
        plot_pc_scatters(merged, pc_cols, str(out_dir / "pca.png"))
        log.info("Wrote pca.png")
        if plot_umap(merged, pc_cols, str(out_dir / "umap.png")):
            log.info("Wrote umap.png")

    if load_path is not None:
        plot_loadings_density(
            pd.read_csv(load_path, sep="\t"), str(out_dir / "loadings.png")
        )
        log.info("Wrote loadings.png")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
