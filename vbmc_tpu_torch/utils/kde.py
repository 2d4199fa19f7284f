"""1-D kernel density estimation with automatic diffusion bandwidth
(Botev, Grotowski & Kroese 2010), as used by the marginal-total-variation
diagnostic (cf. `shared/kde1d.m`), and a 2-D estimate for plots.

The port's own copy of `vbmc_tpu/utils/kde.py` (NumPy only, the same
outputs; `tests/test_torch_vp_queries.py` holds them equal)."""

from __future__ import annotations

import numpy as np


def _dct1d(x):
    n = x.shape[0]
    weight = 2.0 * np.exp(-1j * np.arange(n) * np.pi / (2 * n))
    weight[0] = 1.0
    reordered = np.concatenate([x[::2], x[1::2][::-1]])
    return np.real(weight * np.fft.fft(reordered))


def _idct1d(x):
    n = x.shape[0]
    weight = n * np.exp(1j * np.arange(n) * np.pi / (2 * n))
    data = np.real(np.fft.ifft(weight * x))
    out = np.zeros(n)
    out[::2] = data[:n // 2]
    out[1::2] = data[::-1][:n // 2]
    return out


def _fixed_point(t, N, I, a2):
    l = 7
    f = 2.0 * np.pi ** (2 * l) * np.sum(I ** l * a2 * np.exp(-I * np.pi ** 2 * t))
    for s in range(l - 1, 1, -1):
        K0 = np.prod(np.arange(1, 2 * s, 2)) / np.sqrt(2 * np.pi)
        const = (1 + 0.5 ** (s + 0.5)) / 3.0
        time = (2 * const * K0 / (N * f)) ** (2.0 / (3 + 2 * s))
        f = 2.0 * np.pi ** (2 * s) * np.sum(
            I ** s * a2 * np.exp(-I * np.pi ** 2 * time))
    return t - (2.0 * N * np.sqrt(np.pi) * f) ** (-0.4)


def kde1d(data: np.ndarray, n: int = 2 ** 14, lo=None, hi=None):
    """Return (density (n,), grid (n,)) on [lo, hi]."""
    data = np.asarray(data, float).ravel()
    if lo is None or hi is None:
        mn, mx = data.min(), data.max()
        rng = max(mx - mn, 1e-12)
        lo = mn - rng / 10 if lo is None else lo
        hi = mx + rng / 10 if hi is None else hi
    R = hi - lo
    if R <= 0:
        R = 1.0
        hi = lo + 1.0
    # Bin the data.
    hist, edges = np.histogram(data, bins=n, range=(lo, hi))
    N = max(len(np.unique(data)), 1)
    initial = hist / hist.sum() if hist.sum() > 0 else hist
    a = _dct1d(initial.astype(float))

    I = np.arange(1, n, dtype=float) ** 2
    a2 = (a[1:] / 2.0) ** 2

    # Root of the fixed-point equation by bisection over t in (0, 0.1].
    t_star = None
    f_lo_t, f_hi_t = 1e-12, 0.1
    try:
        flo = _fixed_point(f_lo_t, N, I, a2)
        fhi = _fixed_point(f_hi_t, N, I, a2)
        if np.isfinite(flo) and np.isfinite(fhi) and flo * fhi < 0:
            for _ in range(80):
                mid = 0.5 * (f_lo_t + f_hi_t)
                fm = _fixed_point(mid, N, I, a2)
                if flo * fm <= 0:
                    f_hi_t = mid
                else:
                    f_lo_t, flo = mid, fm
            t_star = 0.5 * (f_lo_t + f_hi_t)
    except FloatingPointError:
        pass
    if t_star is None or not np.isfinite(t_star):
        # Silverman fallback.
        sigma = max(np.std(data, ddof=1), 1e-12)
        h = 1.06 * sigma * len(data) ** (-0.2)
        t_star = (h / R) ** 2

    a_t = a * np.exp(-np.arange(n) ** 2 * np.pi ** 2 * t_star / 2.0)
    density = np.maximum(_idct1d(a_t) / R, 0.0)
    grid = 0.5 * (edges[:-1] + edges[1:])
    z = np.trapezoid(density, grid)
    if z > 0:
        density = density / z
    return density, grid


def kde2d(x: np.ndarray, y: np.ndarray, n: int = 256, lims=None):
    """2-D Gaussian KDE on an n x n grid (cf. `utils/kde2d.m`), with
    per-dimension diffusion bandwidths from the 1-D estimator (a practical
    simplification of Botev's full 2-D fixed point; used for plots).

    Returns (density (n, n), gx (n,), gy (n,)).
    """
    x = np.asarray(x, float).ravel()
    y = np.asarray(y, float).ravel()
    if lims is None:
        rx = max(x.max() - x.min(), 1e-12)
        ry = max(y.max() - y.min(), 1e-12)
        lims = (x.min() - rx / 10, x.max() + rx / 10,
                y.min() - ry / 10, y.max() + ry / 10)
    x0, x1, y0, y1 = lims

    hist, ex, ey = np.histogram2d(x, y, bins=n, range=[[x0, x1], [y0, y1]])
    hist = hist / max(hist.sum(), 1)

    # Marginal (Silverman) bandwidths; adequate for the plotting use case.
    def t_of(d, lo, hi):
        sigma = max(np.std(d, ddof=1), 1e-12)
        return (1.06 * sigma * len(d) ** (-0.2)) ** 2

    tx = t_of(x, x0, x1) / (x1 - x0) ** 2
    ty = t_of(y, y0, y1) / (y1 - y0) ** 2

    # Smooth via 2-D DCT.
    ax = np.apply_along_axis(_dct1d, 0, hist)
    a2 = np.apply_along_axis(_dct1d, 1, ax)
    k = np.arange(n)
    a2 = a2 * np.exp(-k[:, None] ** 2 * np.pi ** 2 * tx / 2.0) \
        * np.exp(-k[None, :] ** 2 * np.pi ** 2 * ty / 2.0)
    sx = np.apply_along_axis(_idct1d, 0, a2)
    dens = np.apply_along_axis(_idct1d, 1, sx)
    dens = np.maximum(dens, 0.0)
    gx = 0.5 * (ex[:-1] + ex[1:])
    gy = 0.5 * (ey[:-1] + ey[1:])
    z = np.trapezoid(np.trapezoid(dens, gy, axis=1), gx)
    if z > 0:
        dens = dens / z
    return dens, gx, gy
