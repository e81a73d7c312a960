"""Per-Gaussian feature-distribution analytics (port of
``utils/feature_analysis.py``, copied unchanged).

``analyze_gaussian_features`` writes ``stats_iter_<N>.txt`` and appends
``history.csv`` under ``<model>/feature_analysis/`` with numpy and ``csv``
only. The plots (``plot_feature_distributions``, ``plot_density``,
``plot_64d_analysis``, ``plot_history_trends``) import matplotlib when
called and raise ``ImportError`` where it is not installed; the neural
entry point checks once and skips them there.
"""

from __future__ import annotations

import csv
import os

import numpy as np


def _outdir(model_path):
    d = os.path.join(model_path, "feature_analysis")
    os.makedirs(d, exist_ok=True)
    return d


def analyze_gaussian_features(features: np.ndarray, iteration: int,
                              model_path: str) -> str:
    """Write the per-iteration stats report + append the CSV history."""
    features = np.asarray(features)
    d = _outdir(model_path)
    stats = {
        "iteration": iteration,
        "num_gaussians": features.shape[0],
        "feature_dims": features.shape[1] if features.ndim > 1 else 0,
        "mean": float(features.mean()) if features.size else 0.0,
        "std": float(features.std()) if features.size else 0.0,
        "min": float(features.min()) if features.size else 0.0,
        "max": float(features.max()) if features.size else 0.0,
        "abs_mean": float(np.abs(features).mean()) if features.size else 0.0,
        "zero_fraction": float((features == 0).mean()) if features.size else 1.0,
    }
    path = os.path.join(d, f"stats_iter_{iteration}.txt")
    with open(path, "w") as f:
        for k, v in stats.items():
            f.write(f"{k}: {v}\n")
        if features.size and features.ndim > 1:
            q1, q3 = np.percentile(features, [25, 75])
            iqr = q3 - q1
            outliers = ((features < q1 - 1.5 * iqr)
                        | (features > q3 + 1.5 * iqr)).mean()
            f.write(f"iqr_outlier_fraction: {float(outliers)}\n")

    hist_path = os.path.join(d, "history.csv")
    write_header = not os.path.exists(hist_path)
    with open(hist_path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(stats.keys()))
        if write_header:
            w.writeheader()
        w.writerow(stats)
    return path


def plot_feature_distributions(features: np.ndarray, iteration: int,
                               model_path: str):
    """Histogram + per-dim box + correlation heatmap (reference :57-195)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    features = np.asarray(features)
    d = _outdir(model_path)
    paths = []

    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(features.reshape(-1), bins=80)
    ax.set_title(f"feature values @ iter {iteration}")
    p = os.path.join(d, f"hist_iter_{iteration}.png")
    fig.savefig(p, dpi=100)
    plt.close(fig)
    paths.append(p)

    if features.ndim > 1 and features.shape[0] > 2:
        fig, ax = plt.subplots(figsize=(8, 4))
        dims = min(features.shape[1], 64)
        ax.boxplot(features[:, :dims], showfliers=False)
        ax.set_title("per-dimension distribution")
        p = os.path.join(d, f"perdim_iter_{iteration}.png")
        fig.savefig(p, dpi=100)
        plt.close(fig)
        paths.append(p)

        corr = np.corrcoef(features.T)
        corr = np.nan_to_num(corr)
        fig, ax = plt.subplots(figsize=(6, 5))
        im = ax.imshow(corr, cmap="coolwarm", vmin=-1, vmax=1)
        fig.colorbar(im)
        ax.set_title("feature correlation")
        p = os.path.join(d, f"corr_iter_{iteration}.png")
        fig.savefig(p, dpi=100)
        plt.close(fig)
        paths.append(p)
    return paths


def plot_density(features: np.ndarray, iteration: int, model_path: str):
    """Density histogram with a normal-fit overlay (reference :101-113:
    the density panel of create_feature_visualizations)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    features = np.asarray(features).reshape(-1)
    d = _outdir(model_path)
    fig, ax = plt.subplots(figsize=(6, 4))
    if features.size:
        ax.hist(features, bins=100, density=True, alpha=0.7,
                color="lightgreen", edgecolor="black")
        mu, sigma = float(features.mean()), float(features.std())
        if sigma > 0:
            x = np.linspace(features.min(), features.max(), 100)
            y = np.exp(-0.5 * ((x - mu) / sigma) ** 2) / (
                sigma * np.sqrt(2 * np.pi))
            ax.plot(x, y, "r-", linewidth=2,
                    label=f"Normal fit (mu={mu:.3f}, sigma={sigma:.3f})")
            ax.legend()
    ax.set_title(f"Feature Values Density @ iter {iteration}")
    ax.set_xlabel("Feature Value")
    ax.set_ylabel("Density")
    ax.grid(True, alpha=0.3)
    p = os.path.join(d, f"density_iter_{iteration}.png")
    fig.savefig(p, dpi=100)
    plt.close(fig)
    return p


def plot_64d_analysis(features: np.ndarray, iteration: int, model_path: str,
                      sample: int = 1000, seed: int = 0):
    """64-d heatmap + per-dimension variance + detailed stats txt
    (reference create_64d_feature_analysis, :275-332)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    features = np.asarray(features)
    if features.ndim != 2 or features.shape[0] == 0:
        return None
    d = _outdir(model_path)
    if features.shape[0] > sample:
        idx = np.random.default_rng(seed).choice(
            features.shape[0], sample, replace=False)
        fs = features[idx]
    else:
        fs = features

    fig, axes = plt.subplots(1, 2, figsize=(14, 6))
    im = axes[0].imshow(fs.T, aspect="auto", cmap="viridis")
    fig.colorbar(im, ax=axes[0])
    axes[0].set_title(f"64D Feature Values Heatmap (iter {iteration})")
    axes[0].set_xlabel("Gaussian Point Index")
    axes[0].set_ylabel("Feature Dimension")
    fvar = np.var(features, axis=0)
    axes[1].bar(range(features.shape[1]), fvar, alpha=0.7, color="coral")
    axes[1].set_title(f"Feature Variance by Dimension (iter {iteration})")
    axes[1].set_xlabel("Feature Dimension")
    axes[1].set_ylabel("Variance")
    axes[1].grid(True, alpha=0.3)
    fig.tight_layout()
    p = os.path.join(d, f"64d_feature_analysis_iter_{iteration}.png")
    fig.savefig(p, dpi=100)
    plt.close(fig)

    stats_path = os.path.join(d, f"64d_detailed_stats_iter_{iteration}.txt")
    with open(stats_path, "w") as f:
        f.write(f"64D Feature Detailed Statistics - Iteration {iteration}\n")
        f.write("=" * 60 + "\n")
        for i in range(features.shape[1]):
            col = features[:, i]
            f.write(f"Dimension {i:2d}: mean={col.mean():.6f}, "
                    f"std={col.std():.6f}, min={col.min():.6f}, "
                    f"max={col.max():.6f}\n")
        f.write("\n" + "=" * 60 + "\n")
        f.write("Summary Statistics:\n")
        f.write(f"Most variable dimension: {int(np.argmax(fvar))}\n")
        f.write(f"Least variable dimension: {int(np.argmin(fvar))}\n")
        f.write(f"Average variance: {float(np.mean(fvar)):.6f}\n")
        f.write(f"Variance of variances: {float(np.var(fvar)):.6f}\n")
    return p


def plot_history_trends(model_path: str):
    """Trend plots from the CSV history (reference :197-273)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = _outdir(model_path)
    hist_path = os.path.join(d, "history.csv")
    if not os.path.exists(hist_path):
        return None
    with open(hist_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None
    iters = [int(float(r["iteration"])) for r in rows]
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    for ax, key in zip(axes, ["mean", "std", "abs_mean"]):
        ax.plot(iters, [float(r[key]) for r in rows])
        ax.set_title(key)
        ax.set_xlabel("iteration")
    p = os.path.join(d, "trends.png")
    fig.savefig(p, dpi=100)
    plt.close(fig)
    return p
