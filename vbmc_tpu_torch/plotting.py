"""Plotting utilities (cf. `vbmc_tpu/plotting.py`, `vbmc_plot.m`,
`utils/cornerplot.m`, `private/vbmc_iterplot.m`). Matplotlib is imported
inside each function, so nothing else of the package needs it; the draws
and densities are computed on the VP's device and plotted from the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vbmc_tpu_torch.utils.math import to_np


def cornerplot(X, names: Optional[Sequence[str]] = None,
               truths: Optional[np.ndarray] = None, fig=None, color="k"):
    """Pairwise-marginal corner plot of samples X (n, D)
    (cf. `utils/cornerplot.m`). Returns the matplotlib figure."""
    import matplotlib.pyplot as plt

    X = to_np(X) if isinstance(X, torch.Tensor) else np.asarray(X)
    D = X.shape[1]
    if names is None:
        names = [f"x{i + 1}" for i in range(D)]
    if fig is None:
        fig, axes = plt.subplots(D, D, figsize=(2.2 * D, 2.2 * D),
                                 squeeze=False)
    else:
        axes = np.asarray(fig.axes).reshape(D, D)

    for i in range(D):
        for j in range(D):
            ax = axes[i][j]
            if j > i:
                ax.set_visible(False)
                continue
            if i == j:
                ax.hist(X[:, i], bins=40, density=True, color=color,
                        alpha=0.6, histtype="stepfilled")
                if truths is not None:
                    ax.axvline(truths[i], color="r", lw=1)
            else:
                ax.hist2d(X[:, j], X[:, i], bins=48, cmap="Greys")
                if truths is not None:
                    ax.plot(truths[j], truths[i], "r+", ms=10)
            if i == D - 1:
                ax.set_xlabel(names[j])
            else:
                ax.set_xticklabels([])
            if j == 0 and i > 0:
                ax.set_ylabel(names[i])
            else:
                ax.set_yticklabels([])
    fig.tight_layout()
    return fig


def vbmc_plot(vps, n_samples: int = 10 ** 5, names=None, truths=None,
              gen: Optional[torch.Generator] = None):
    """Corner plot of one or more variational posteriors (cf. `vbmc_plot.m`).

    ``vps``: a VariationalPosterior, a VBMCResult, or a list of either."""
    from vbmc_tpu_torch.vp import vp_rnd, is_valid_vp

    if not isinstance(vps, (list, tuple)):
        vps = [vps]
    fig = None
    colors = ["k", "b", "g", "m", "c"]
    for i, v in enumerate(vps):
        vp = v if is_valid_vp(v) else v.vp
        if gen is None:
            gen = torch.Generator(device=vp.mu.device).manual_seed(0)
        with torch.no_grad():
            X = to_np(vp_rnd(vp, gen, n_samples, orig_flag=True))
        fig = cornerplot(X, names=names, truths=truths, fig=fig,
                         color=colors[i % len(colors)])
    return fig


def plot_run(result, target_logpdf=None, bounds=None, n_grid: int = 80):
    """Contours of a finished 2-D run's posterior with its evaluations
    (cf. `private/vbmc_plot2d.m`)."""
    import matplotlib.pyplot as plt
    from vbmc_tpu_torch.vp import vp_rnd, vp_pdf

    vp = result.vp
    assert vp.D == 2, "plot_run supports 2-D problems"
    gen = torch.Generator(device=vp.mu.device).manual_seed(0)
    with torch.no_grad():
        X = to_np(vp_rnd(vp, gen, 20000, orig_flag=True))
    if bounds is None:
        lo, hi = X.min(0) - 0.5 * X.std(0), X.max(0) + 0.5 * X.std(0)
    else:
        lo, hi = bounds
    g1 = np.linspace(lo[0], hi[0], n_grid)
    g2 = np.linspace(lo[1], hi[1], n_grid)
    GX, GY = np.meshgrid(g1, g2)
    pts = np.stack([GX.ravel(), GY.ravel()], 1)
    with torch.no_grad():
        P = to_np(vp_pdf(vp, pts, orig_flag=True)).reshape(n_grid, n_grid)

    fig, ax = plt.subplots(figsize=(6, 5))
    ax.contour(GX, GY, P, levels=10, cmap="viridis")
    Xtr = result.logger.X_orig[:result.logger.Xn]
    ax.plot(Xtr[:, 0], Xtr[:, 1], "k.", ms=3, alpha=0.5,
            label="evaluations")
    if target_logpdf is not None:
        T = np.asarray([target_logpdf(p) for p in pts]).reshape(n_grid,
                                                                n_grid)
        ax.contour(GX, GY, np.exp(T - T.max()), levels=6, cmap="Reds",
                   alpha=0.5)
    ax.set_title(f"ELBO = {result.elbo:.2f} ± {result.elbo_sd:.2f}")
    ax.legend()
    fig.tight_layout()
    return fig


def iteration_plot(stats, vp, logger, save_dir: Optional[str] = None,
                   show: bool = True):
    """Per-iteration diagnostic (cf. `private/vbmc_iterplot.m`,
    `vbmc_plot2d.m`): the ELBO trace with its uncertainty band and, for
    D <= 2, the current VP density with the training points (original
    space).

    Called from the main loop when ``options.plot`` is on. Pass
    ``save_dir`` (or set VBMC_PLOT_DIR) to write one PNG per iteration
    instead of drawing interactively."""
    import os
    import matplotlib
    if save_dir is None:
        save_dir = os.environ.get("VBMC_PLOT_DIR")
    if save_dir is not None:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from vbmc_tpu_torch.transforms import inverse_np
    from vbmc_tpu_torch.vp import vp_pdf

    it = len(stats)
    elbo = stats.series("elbo")
    elbo_sd = stats.series("elbo_sd")
    iters = np.arange(1, it + 1)

    D = logger.D
    two_d = D <= 2
    fig, axes = plt.subplots(1, 2 if two_d else 1,
                             figsize=(10 if two_d else 5, 4))
    ax0 = axes[0] if two_d else axes
    ax0.plot(iters, elbo, "k.-")
    ax0.fill_between(iters, elbo - elbo_sd, elbo + elbo_sd, color="k",
                     alpha=0.2)
    ax0.set_xlabel("iteration")
    ax0.set_ylabel("ELBO")
    ax0.set_title(f"iter {it}  K={stats.last.K}  N={stats.last.N}")

    if two_d:
        ax1 = axes[1]
        n = logger.Xn
        X_orig = inverse_np(logger.trinfo, logger.X[:n])
        if D == 2:
            pad = 0.5 * (X_orig.max(0) - X_orig.min(0) + 1e-6)
            lo, hi = X_orig.min(0) - pad, X_orig.max(0) + pad
            g1 = np.linspace(lo[0], hi[0], 60)
            g2 = np.linspace(lo[1], hi[1], 60)
            G1, G2 = np.meshgrid(g1, g2)
            pts = np.stack([G1.ravel(), G2.ravel()], axis=1)
            with torch.no_grad():
                pdf = to_np(vp_pdf(vp, pts, orig_flag=True)).reshape(G1.shape)
            ax1.contour(G1, G2, pdf, levels=8, cmap="viridis")
            ax1.plot(X_orig[:, 0], X_orig[:, 1], "k.", ms=3, alpha=0.5)
            ax1.set_xlabel("x1")
            ax1.set_ylabel("x2")
        else:
            lo = X_orig.min() - 1.0
            hi = X_orig.max() + 1.0
            g = np.linspace(lo, hi, 200)[:, None]
            with torch.no_grad():
                pdf = to_np(vp_pdf(vp, g, orig_flag=True))
            ax1.plot(g[:, 0], pdf, "b-")
            ax1.plot(X_orig[:, 0], np.zeros(n), "k|", ms=12)
            ax1.set_xlabel("x1")
            ax1.set_ylabel("vp pdf")
        ax1.set_title("variational posterior")
    fig.tight_layout()
    if save_dir is not None:
        os.makedirs(save_dir, exist_ok=True)
        fig.savefig(os.path.join(save_dir, f"iter_{it:03d}.png"), dpi=100)
        plt.close(fig)
    elif show:
        plt.show(block=False)
        plt.pause(0.01)
    return fig
