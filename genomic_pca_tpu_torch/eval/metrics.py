"""Population-structure quality metrics for PC scores.

A copy of `genomic_pca_tpu/eval/metrics.py`, the port of the reference's
metric suite (tests/metrics.py), kept in the port so it imports nothing
of the JAX package.  It runs on a host with pandas, scikit-learn and
scipy (no card).  Per superpopulation —

* 5-fold CV logistic-regression balanced accuracy over subpopulation
  labels (admixed subpops ACB/ASW/CLM/MXL/PEL/PUR excluded,
  metrics.py:32) plus its chance-normalized skill score;
* Monte-Carlo multivariate Jensen-Shannon divergence between
  per-subpopulation Gaussian KDEs (pairwise; mean & median);
* silhouette statistics; contrastive-violation statistics;
* best HDBSCAN adjusted mutual information over a parameter search
  (metrics.py:129-168; sklearn's HDBSCAN stands in for the hdbscan
  package).

Output TSV schema matches the reference (column list at
metrics.py:253-266) so downstream sweep analysis is drop-in compatible.
"""

from __future__ import annotations

import argparse
import logging
import warnings
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd

log = logging.getLogger(__name__)

LOGREG_EXCLUDED_SUBPOPS = ["ACB", "ASW", "CLM", "MXL", "PEL", "PUR"]

COLUMNS = [
    "Superpopulation",
    "Number_of_samples",
    "Number_of_subpopulations",
    "LogReg_Balanced_Accuracy_CV",
    "LogReg_Normalized_Accuracy_CV",
    "Mean_multivariate_Jensen_Shannon_divergence_nats",
    "Median_multivariate_Jensen_Shannon_divergence_nats",
    "Average_silhouette",
    "Median_silhouette",
    "Mean_contrastive_violation",
    "Median_contrastive_violation",
    "HDBSCAN_adjusted_mutual_information",
]


def _fit_kdes(x: np.ndarray, labels: np.ndarray):
    from sklearn.neighbors import KernelDensity

    per_label = {}
    for lab in np.unique(labels):
        per_label[lab] = KernelDensity(kernel="gaussian", bandwidth="scott").fit(
            x[labels == lab]
        )
    pooled = KernelDensity(kernel="gaussian", bandwidth="scott").fit(x)
    return per_label, pooled


def monte_carlo_jsd(kde_a, kde_b, mc_samples: int = 4000, seed: int = 42) -> float:
    """MC Jensen-Shannon divergence (nats) between two multivariate KDEs.

    JSD = 0.5 KL(a || m) + 0.5 KL(b || m), m = (a+b)/2, estimated with
    each KL term averaged over samples from ITS OWN distribution.  (The
    reference averages both terms over the pooled sample set,
    metrics.py:97-103, which estimates E_m[log sqrt(pa*pb) - log m] <= 0
    — a sign-inverted separation score, not JSD.  This implementation
    returns the actual divergence, in [0, ln 2].)
    """
    half = mc_samples // 2
    sa = kde_a.sample(half, random_state=seed & 0xFFFFFFFF)
    sb = kde_b.sample(mc_samples - half, random_state=(seed + 1) & 0xFFFFFFFF)

    la_a = kde_a.score_samples(sa)
    lb_a = kde_b.score_samples(sa)
    lmix_a = np.logaddexp(la_a, lb_a) - np.log(2.0)

    la_b = kde_a.score_samples(sb)
    lb_b = kde_b.score_samples(sb)
    lmix_b = np.logaddexp(la_b, lb_b) - np.log(2.0)

    return float(0.5 * np.mean(la_a - lmix_a) + 0.5 * np.mean(lb_b - lmix_b))


def contrastive_violation_stats(
    x: np.ndarray, labels: np.ndarray
) -> Tuple[float, float]:
    """violation_i = max(0, mean intra-subpop dist - min inter-subpop dist).

    Deviation from the reference: its `other_mask = ~same_mask` keeps the
    self-distance 0 in the minimum (metrics.py:117-121), collapsing the
    metric to the mean intra-cluster distance.  Here "other" means
    samples with a *different* label, which is the metric the docstring
    describes.
    """
    from scipy.spatial.distance import cdist

    dm = cdist(x, x)
    out = np.zeros(len(x))
    for i in range(len(x)):
        same = labels == labels[i]
        same[i] = False
        intra = dm[i, same].mean() if same.any() else 0.0
        inter_mask = labels != labels[i]
        inter = dm[i, inter_mask].min() if inter_mask.any() else np.inf
        out[i] = max(0.0, intra - inter) if np.isfinite(inter) else 0.0
    return float(out.mean()), float(np.median(out))


def best_hdbscan_ami(
    x: np.ndarray,
    labels: np.ndarray,
    search_fracs: Tuple[float, ...] = (0.02, 0.04, 0.06, 0.08, 0.10, 0.15, 0.20, 0.30),
) -> float:
    """Best adjusted MI over an HDBSCAN parameter search (0.0 if none)."""
    from sklearn.cluster import HDBSCAN
    from sklearn.metrics import adjusted_mutual_info_score

    n = len(labels)
    best = 0.0
    for frac in search_fracs:
        mcs = max(2, int(round(frac * n)))
        for ms in {1, mcs // 2, mcs}:
            try:
                pred = HDBSCAN(
                    min_cluster_size=mcs,
                    min_samples=max(ms, 1),
                    metric="euclidean",
                    cluster_selection_method="leaf",
                ).fit_predict(x)
            except Exception:
                continue
            core = pred != -1
            if core.sum() < 2 or len(np.unique(pred[core])) < 2:
                continue
            best = max(
                best,
                adjusted_mutual_info_score(
                    labels[core], pred[core], average_method="arithmetic"
                ),
            )
    return float(best)


def logreg_balanced_accuracy(
    x: np.ndarray, labels: np.ndarray, n_splits: int = 5, seed: int = 42
) -> float:
    """5-fold CV balanced accuracy of an L2 logistic regression."""
    from sklearn.linear_model import LogisticRegression
    from sklearn.metrics import balanced_accuracy_score, make_scorer
    from sklearn.model_selection import StratifiedKFold, cross_val_score
    from sklearn.preprocessing import LabelEncoder

    classes, counts = np.unique(labels, return_counts=True)
    if len(classes) < 2 or len(x) < n_splits or (counts < n_splits).any():
        return float("nan")
    y = LabelEncoder().fit_transform(labels)
    model = LogisticRegression(
        penalty="l2", solver="lbfgs", random_state=seed, max_iter=300, C=1.0
    )
    cv = StratifiedKFold(n_splits=n_splits, shuffle=True, random_state=seed)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            scores = cross_val_score(
                model, x, y, cv=cv, scoring=make_scorer(balanced_accuracy_score)
            )
        return float(np.mean(scores))
    except ValueError:
        return float("nan")


def compute_superpopulation_metrics(
    merged: pd.DataFrame,
    pc_columns: List[str],
    mc_samples: int = 4000,
) -> pd.DataFrame:
    """Metric table, one row per superpopulation (schema = COLUMNS)."""
    rows = []
    for spop in sorted(merged["Superpopulation code"].unique()):
        sub = merged[merged["Superpopulation code"] == spop]
        x = sub[pc_columns].to_numpy()
        labels = sub["Population code"].to_numpy()
        uniq = np.unique(labels)

        # Logistic regression on the admixture-filtered subset.
        keep = ~sub["Population code"].isin(LOGREG_EXCLUDED_SUBPOPS)
        x_lr = sub[keep][pc_columns].to_numpy()
        y_lr = sub[keep]["Population code"].to_numpy()
        acc = norm_acc = float("nan")
        n_lr_classes = len(np.unique(y_lr)) if len(y_lr) else 0
        if n_lr_classes >= 2:
            acc = logreg_balanced_accuracy(x_lr, y_lr)
            if not np.isnan(acc):
                chance = 1.0 / n_lr_classes
                norm_acc = (
                    (acc - chance) / (1.0 - chance) if acc >= chance else 0.0
                )

        # Pairwise JSD over per-subpop KDEs.
        jsds: List[float] = []
        if len(x) > 0 and len(uniq) > 1:
            kdes, _pooled = _fit_kdes(x, labels)
            for i, a in enumerate(uniq):
                for b in uniq[i + 1 :]:
                    jsds.append(
                        monte_carlo_jsd(
                            kdes[a], kdes[b], mc_samples=mc_samples,
                            seed=17 + len(jsds),
                        )
                    )
        mean_jsd = float(np.mean(jsds)) if jsds else float("nan")
        med_jsd = float(np.median(jsds)) if jsds else float("nan")

        avg_sil = med_sil = float("nan")
        if len(uniq) >= 2 and len(x) > len(uniq):
            from sklearn.metrics import silhouette_samples

            try:
                sil = silhouette_samples(x, labels)
                avg_sil, med_sil = float(sil.mean()), float(np.median(sil))
            except ValueError:
                pass

        mean_cv, med_cv = contrastive_violation_stats(x, labels)
        ami = best_hdbscan_ami(x, labels)

        rows.append(
            dict(
                zip(
                    COLUMNS,
                    [
                        spop,
                        len(sub),
                        len(uniq),
                        acc,
                        norm_acc,
                        mean_jsd,
                        med_jsd,
                        avg_sil,
                        med_sil,
                        mean_cv,
                        med_cv,
                        ami,
                    ],
                )
            )
        )
    return pd.DataFrame(rows, columns=COLUMNS)


def load_and_merge(
    pca_file: str, sample_file: str, number_of_pcs: int
) -> Tuple[pd.DataFrame, List[str]]:
    """Join a *.pca.tsv with an igsr-style sample table and z-score PCs."""
    from sklearn.preprocessing import StandardScaler

    pca = pd.read_csv(pca_file, sep=r"\s+")
    samples = pd.read_csv(sample_file, sep="\t")
    pc_cols = [f"PC{i+1}" for i in range(number_of_pcs)]
    for col in ["SampleID"] + pc_cols:
        if col not in pca.columns:
            raise ValueError(f"Column '{col}' missing in PCA file.")
    needed = ["Sample name", "Population code", "Superpopulation code"]
    for col in needed:
        if col not in samples.columns:
            raise ValueError(f"Column '{col}' missing in sample file.")
    merged = pca.merge(
        samples[needed], left_on="SampleID", right_on="Sample name", how="inner"
    )
    if merged.empty:
        raise ValueError("No overlapping Sample IDs between PCA and sample tables.")
    merged[pc_cols] = StandardScaler().fit_transform(merged[pc_cols])
    return merged, pc_cols


def write_metrics_tsv(df: pd.DataFrame, path: str) -> None:
    lines = ["\t".join(COLUMNS)]
    for _, row in df.iterrows():
        vals = []
        for col in COLUMNS:
            v = row[col]
            if isinstance(v, float):
                vals.append("NaN" if np.isnan(v) else f"{v:.6f}")
            else:
                vals.append(str(v))
        lines.append("\t".join(vals))
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Population-structure metrics per superpopulation."
    )
    p.add_argument("--pca_file", required=True)
    p.add_argument("--sample_file", required=True)
    p.add_argument("--number_of_pcs", type=int, default=10)
    p.add_argument("--mc_samples", type=int, default=4000)
    p.add_argument("--output_tsv", default="population_metrics_summary.tsv")
    args = p.parse_args(argv)

    merged, pc_cols = load_and_merge(
        args.pca_file, args.sample_file, args.number_of_pcs
    )
    df = compute_superpopulation_metrics(merged, pc_cols, args.mc_samples)
    write_metrics_tsv(df, args.output_tsv)
    print(f"Wrote {len(df)} rows to {args.output_tsv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
