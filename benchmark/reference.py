"""The plain reference that decides ``correct``: NumPy in float64, written
from the model's definition (gplite's SE-ard GP with a negative-quadratic
mean, VBMC's Bayesian-quadrature expected log joint and its two
acquisitions), importing nothing of the program under test.

Everything here runs on the host after the measured window has closed, in
blocks of candidates so that the temporaries stay small.

Hyperparameter layout of one sample (gplite, `gplite_covfun.m`,
`gplite_noisefun.m`, `gplite_meanfun.m` case 4): log length scales (D), log
output scale, log noise SD, then the mean's m0, its centre xm (D) and its
log widths log omega (D). The noise variance of point n is exp(2 log sn)
plus, for a target that reports its own noise, that target's SD squared.
"""

from __future__ import annotations

import math

import numpy as np

LOG2PI = math.log(2.0 * math.pi)
U_IQR = 0.6744897501960817          # the normal's 75% quantile
LOG_REALMIN = -708.0
CAND_BLOCK = 512                    # candidates per block of the sweeps


# ---------------------------------------------------------------- transform

def transform_fields(lb, ub, plb, pub):
    """The input transform of VBMC (`warpvars_vbmc.m`) before any warp: per
    dimension unbounded (affine) or bounded (logit), recentred on the
    transformed plausible box. Returns a dict of host arrays."""
    lb, ub, plb, pub = (np.asarray(a, float).ravel() for a in (lb, ub, plb,
                                                               pub))
    bounded = np.isfinite(lb) & np.isfinite(ub)
    if np.any(np.isfinite(lb) ^ np.isfinite(ub)):
        raise ValueError("one-sided bounds are not part of any deployment")
    a = np.where(bounded, lb, 0.0)
    b = np.where(bounded, ub, 1.0)

    def raw(x):
        z = np.clip((x - a) / (b - a), 1e-300, 1.0 - 1e-16)
        return np.where(bounded, np.log(z) - np.log1p(-z), x)

    tplb, tpub = raw(plb), raw(pub)
    return dict(bounded=bounded, a=a, b=b, lb=lb, ub=ub,
                mu=0.5 * (tplb + tpub), delta=tpub - tplb)


def to_train_space(f, x, R, scale):
    """Original-space rows x (n, D) to the GP's space, with the log
    Jacobian log |dx/du| of each row. ``R`` and ``scale`` are an input
    warp's rotation and scaling (the identity and ones before a warp)."""
    x = np.atleast_2d(np.asarray(x, float))
    z = np.clip((x - f["a"]) / (f["b"] - f["a"]), 1e-300, 1.0 - 1e-16)
    u = np.where(f["bounded"], np.log(z) - np.log1p(-z), x)
    y = (u - f["mu"]) / f["delta"]
    logj = np.log(f["delta"]) * np.ones_like(u)
    lab = np.log(f["b"] - f["a"])
    logj = np.where(f["bounded"],
                    lab - np.logaddexp(0.0, u) - np.logaddexp(0.0, -u)
                    + np.log(f["delta"]), logj)
    return (y @ R) / scale, (logj + np.log(scale)).sum(-1)


def to_orig_space(f, U, R, scale):
    """GP-space rows U (n, D) back to original space."""
    y = (np.asarray(U, float) * scale) @ R.T
    u = y * f["delta"] + f["mu"]
    sig = 0.5 * (1.0 + np.tanh(0.5 * u))
    x = np.where(f["bounded"], f["a"] + (f["b"] - f["a"]) * sig, u)
    return np.where(f["bounded"], np.clip(x, f["a"], f["b"]), x)


def outside_eps_box(f, U, R, scale, tol_bound_x):
    """Candidates whose original-space image lies outside the hard bounds
    shrunk by ``tol_bound_x`` of their width (rejected by VBMC)."""
    x = to_orig_space(f, U, R, scale)
    w = np.where(f["bounded"], f["ub"] - f["lb"], 0.0)
    lo = np.where(f["bounded"], f["lb"] + w * tol_bound_x, -np.inf)
    hi = np.where(f["bounded"], f["ub"] - w * tol_bound_x, np.inf)
    return (x < lo).any(1) | (x > hi).any(1)


# ----------------------------------------------------------------------- GP

def unpack(hyp, D):
    """(ell (S, D), sf2 (S,), sn2 const (S,), m0 (S,), xm (S, D),
    omega2 (S, D)) of hyperparameter samples hyp (S, 3 D + 3)."""
    hyp = np.atleast_2d(np.asarray(hyp, float))
    if hyp.shape[1] != 3 * D + 3:
        raise ValueError(f"expected 3 D + 3 = {3 * D + 3} hyperparameters "
                         f"(SE-ard, one noise term, negquad mean), got "
                         f"{hyp.shape[1]}")
    ell = np.exp(hyp[:, :D])
    sf2 = np.exp(2.0 * hyp[:, D])
    sn2 = np.exp(2.0 * hyp[:, D + 1])
    m0 = hyp[:, D + 2]
    xm = hyp[:, D + 3:2 * D + 3]
    omega2 = np.exp(2.0 * hyp[:, 2 * D + 3:3 * D + 3])
    return ell, sf2, sn2, m0, xm, omega2


def kernel(ell_s, sf2_s, A, B):
    """SE-ard covariance k(A, B) for one sample: (n, m), from direct
    differences (no cancellation where the scaled inputs are large)."""
    d2 = ((((A[:, None, :] - B[None, :, :]) / ell_s) ** 2)).sum(-1)
    return sf2_s * np.exp(-0.5 * d2)


def mean_fn(m0_s, xm_s, omega2_s, X):
    return m0_s - 0.5 * (((X - xm_s) ** 2) / omega2_s).sum(1)


def _ladder(B):
    """The diagonal shifts of gplite's jitter escalation
    (`gplite_core.m:78-95`): none, then 10^(t-12) times the mean diagonal,
    t = 1..11."""
    scale = np.abs(np.diag(B)).mean()
    return [0.0] + [scale * 10.0 ** (t - 12) for t in range(1, 12)]


def _factors(B):
    try:
        np.linalg.cholesky(B)
        return True
    except np.linalg.LinAlgError:
        return False


def _cholesky(B):
    """Cholesky of B at the first step of the jitter ladder that
    factors."""
    eye = np.eye(B.shape[0])
    for jit in _ladder(B):
        try:
            return np.linalg.cholesky(B + jit * eye)
        except np.linalg.LinAlgError:
            continue
    raise np.linalg.LinAlgError("no step of the jitter ladder factors B")


def jitter_steps(B):
    """The steps of the ladder a sound solver may have used on B: the one
    at which the reference's own Cholesky first factors, t, and one step
    of slack on either side for a solver that rounds B apart. Where B
    factors unshifted (t = 0) the slack of one step up holds only if B
    lies within one step of failing (B minus that step does not factor);
    otherwise no shift is sound."""
    ladder = _ladder(B)
    eye = np.eye(B.shape[0])
    t = next((i for i, jit in enumerate(ladder) if _factors(B + jit * eye)),
             len(ladder) - 1)
    steps = {t}
    if t > 0:
        steps.update({t - 1, min(t + 1, len(ladder) - 1)})
    elif not _factors(B - ladder[1] * eye):
        steps.add(1)
    return [ladder[i] for i in sorted(steps)]


class Posterior:
    """The GP posterior of every hyperparameter sample on training rows X
    (N, D), observations y (N,) and user noise variances s2 (N,) or None.
    ``factors`` = (alpha (S, N), Binv (S, N, N)) reads another solver's
    factorisation in place of solving; `residuals` judges it."""

    def __init__(self, X, y, s2, hyp, factors=None):
        self.X = np.asarray(X, float)
        self.y = np.asarray(y, float)
        N, D = self.X.shape
        self.D = D
        (self.ell, self.sf2, self.sn2c, self.m0, self.xm,
         self.omega2) = unpack(hyp, D)
        S = self.ell.shape[0]
        s2 = np.zeros(N) if s2 is None else np.asarray(s2, float)
        self.sn2 = self.sn2c[:, None] + s2[None, :]            # (S, N)
        self.B = np.empty((S, N, N))
        self.r = np.empty((S, N))
        for s in range(S):
            K = kernel(self.ell[s], self.sf2[s], self.X, self.X)
            self.B[s] = K + np.diag(self.sn2[s])
            self.r[s] = self.y - mean_fn(self.m0[s], self.xm[s],
                                         self.omega2[s], self.X)
        if factors is not None:
            self.alpha, self.Binv = (np.asarray(f, float) for f in factors)
            return
        self.alpha = np.empty((S, N))
        self.Binv = np.empty((S, N, N))
        eye = np.eye(N)
        for s in range(S):
            Linv = np.linalg.solve(_cholesky(self.B[s]), eye)
            self.Binv[s] = Linv.T @ Linv
            self.alpha[s] = self.Binv[s] @ self.r[s]

    def residuals(self):
        """Componentwise backward errors of the factorisation (Oettli and
        Prager): max |B alpha - r| / (E |alpha| + f) and max |B Binv - I| /
        (E |Binv|), where E and f bound the rounding of B and r entry by
        entry. E_ij = K_ij (1 + w_i + w_j) + delta_ij sn2_i, with w_i the
        squared norm of row i in length scales (a Gram matrix evaluated by
        the expansion |a|^2 + |b|^2 - 2 a.b, as on the card, is off by
        about eps K_ij (w_i + w_j)); f the sum of the magnitudes of y and
        of the mean's terms. Each sample is read against B plus each
        shift of gplite's jitter ladder that B itself calls for
        (`jitter_steps`: none where B factors clear of the ladder's first
        step), and the best fit counts; the largest over samples is
        returned. A float64 program reads about 1e-16 times a small factor
        whatever B's condition; a float32 one about 1e-8 or more, which no
        diagonal shift explains; a program that shifts a B which needs no
        shift reads about the shift over B's diagonal."""
        ea, eb = 0.0, 0.0
        N = self.X.shape[0]
        eye = np.eye(N)
        tiny = np.finfo(float).tiny
        for s in range(self.S):
            w = ((self.X / self.ell[s]) ** 2).sum(1)
            B = self.B[s]
            E = (np.abs(B - np.diag(self.sn2[s])) * (1.0 + w[:, None]
                                                     + w[None, :])
                 + np.diag(self.sn2[s]))
            f = (np.abs(self.y) + abs(self.m0[s])
                 + 0.5 * (((self.X - self.xm[s]) ** 2)
                          / self.omega2[s]).sum(1))
            a, Bi = self.alpha[s], self.Binv[s]
            Ra, Rb = B @ a - self.r[s], B @ Bi - eye
            Da, Db = E @ np.abs(a) + f + tiny, E @ np.abs(Bi) + tiny
            best = None
            for jit in jitter_steps(B):
                pa = float((np.abs(Ra + jit * a) / (Da + jit * np.abs(a))).max())
                pb = float((np.abs(Rb + jit * Bi)
                            / (Db + jit * np.abs(Bi))).max())
                if best is None or max(pa, pb) < max(best):
                    best = (pa, pb)
            ea, eb = max(ea, best[0]), max(eb, best[1])
        return ea, eb

    @property
    def S(self):
        return self.alpha.shape[0]

    def ks(self, s, Xs):
        return kernel(self.ell[s], self.sf2[s], self.X, Xs)      # (N, M)

    def predict(self, Xs, alpha=None, Binv=None):
        """Per-sample latent mean and variance (S, M) at Xs; ``alpha`` and
        ``Binv`` replace this posterior's own (to read another's)."""
        alpha = self.alpha if alpha is None else alpha
        Binv = self.Binv if Binv is None else Binv
        S, M = self.S, Xs.shape[0]
        fmu, fs2 = np.empty((S, M)), np.empty((S, M))
        for s in range(S):
            k = self.ks(s, Xs)
            fmu[s] = (mean_fn(self.m0[s], self.xm[s], self.omega2[s], Xs)
                      + k.T @ alpha[s])
            fs2[s] = np.maximum(self.sf2[s] - (k * (Binv[s] @ k)).sum(0),
                                0.0)
        return fmu, fs2


def summary(fmu, fs2):
    """Mean over samples and total variance (mean variance plus the
    between-sample variance, ddof 1): (fbar (M,), vtot (M,))."""
    S = fmu.shape[0]
    fbar = fmu.mean(0)
    vf = fmu.var(0, ddof=1) if S > 1 else np.zeros_like(fbar)
    return fbar, fs2.mean(0) + vf


# ------------------------------------------------------------------- ELBO

def expected_log_joint(post: Posterior, mu, sigma, lam, w):
    """E_q[f] of the Gaussian mixture q = sum_k w_k N(mu_k, diag(sigma_k^2
    lam^2)) under the GP posterior mean, averaged over samples
    (Bayesian quadrature with the SE-ard kernel; `gplogjoint.m`)."""
    mu = np.asarray(mu, float)
    s2l2 = (np.asarray(sigma, float)[:, None] ** 2
            * np.asarray(lam, float)[None, :] ** 2)              # (K, D)
    F = np.empty(post.S)
    for s in range(post.S):
        tau2 = s2l2 + post.ell[s] ** 2                           # (K, D)
        lnnf = (math.log(post.sf2[s]) + np.log(post.ell[s]).sum()
                - 0.5 * np.log(tau2).sum(1))                     # (K,)
        d2 = (((mu[:, None, :] - post.X[None]) ** 2)
              / tau2[:, None, :]).sum(-1)                        # (K, N)
        z = np.exp(lnnf[:, None] - 0.5 * d2)
        nu = post.m0[s] - 0.5 * (((mu - post.xm[s]) ** 2 + s2l2)
                                 / post.omega2[s]).sum(1)
        F[s] = w @ (z @ post.alpha[s] + nu)
    return float(F.mean())


def vp_log_pdf(mu, sigma, lam, w, X):
    """Log density of the mixture at rows X (M, D)."""
    mu = np.asarray(mu, float)
    scale = np.asarray(sigma, float)[:, None] * np.asarray(lam, float)[None]
    D = mu.shape[1]
    z2 = (((X[None] - mu[:, None]) / scale[:, None]) ** 2).sum(-1)
    comp = (-0.5 * D * LOG2PI - np.log(scale).sum(1)[:, None] - 0.5 * z2
            + np.log(np.maximum(w, 1e-300))[:, None])
    m = comp.max(0)
    return m + np.log(np.exp(comp - m).sum(0))


# ------------------------------------------------------------ acquisitions

def prospective(post: Posterior, vp, Xs, ymax, tol_var):
    """The "prospective" acquisition (`acqfprospective_vbmc.m`) with VBMC's
    variance regularisation, before the hard-bound rejection (M,)."""
    out = np.empty(Xs.shape[0])
    big = np.finfo(float).max
    for i in range(0, Xs.shape[0], CAND_BLOCK):
        C = Xs[i:i + CAND_BLOCK]
        fbar, vtot = summary(*post.predict(C))
        logq = np.maximum(vp_log_pdf(*vp, C), LOG_REALMIN)
        acq = -vtot * np.exp(fbar - ymax + logq)
        low = vtot < tol_var
        ratio = tol_var / np.maximum(vtot, np.finfo(float).tiny)
        acq = np.where(low, acq * np.exp(-(ratio - 1.0)), acq)
        out[i:i + CAND_BLOCK] = np.maximum(acq, -big)
    return out


def prospective_condition(post: Posterior, Xs, tol_var):
    """A bound on the relative change of the "prospective" acquisition
    (M,) that float64 rounding in the solves with the Gram matrix can make
    at each candidate: the predictive variance sf2 - k^T B^-1 k is off by
    up to eps (sf2 + |k|^T |B^-1| |k|), which moves the acquisition by
    that times 1 / vtot (plus tol_var / vtot^2 where the regulariser
    acts), and the mean m + k^T alpha by up to eps (|m| + |k|^T |alpha|).
    Near the training rows of an ill-conditioned GP the variance is
    rounding, and no two float64 programs agree there."""
    eps = np.finfo(float).eps
    out = np.empty(Xs.shape[0])
    for i in range(0, Xs.shape[0], CAND_BLOCK):
        C = Xs[i:i + CAND_BLOCK]
        fbar, vtot = summary(*post.predict(C))
        dv, dm = np.zeros(C.shape[0]), np.zeros(C.shape[0])
        for s in range(post.S):
            k = np.abs(post.ks(s, C))
            m = np.abs(mean_fn(post.m0[s], post.xm[s], post.omega2[s], C))
            dv = np.maximum(dv, post.sf2[s]
                            + (k * (np.abs(post.Binv[s]) @ k)).sum(0))
            dm = np.maximum(dm, m + k.T @ np.abs(post.alpha[s]))
        v = np.maximum(vtot, np.finfo(float).tiny)
        kappa = 1.0 / v + np.where(vtot < tol_var, tol_var / v ** 2, 0.0)
        out[i:i + CAND_BLOCK] = eps * (kappa * dv + dm)
    return out


def nearest_noise(post: Posterior, Xs):
    """Noise variance at each candidate: that of the nearest training row
    in units of the geometric-mean length scale (`acqfsn2_vbmc.m`)."""
    gls = np.exp(np.log(post.ell).mean(0))
    a, b = Xs / gls, post.X / gls
    d2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T
    return post.sn2.mean(0)[np.argmin(d2, axis=1)]


def _logsumexp(a, axis):
    m = np.max(a, axis=axis, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    return np.squeeze(m, axis) + np.log(np.exp(a - m).sum(axis))


def viqr(post: Posterior, Xs, Xa, ln_weights, tol_var):
    """The log of VIQR (`acqviqr_vbmc.m`) at candidates Xs, for the
    integration points Xa (Na, D) and their normalised log importance
    weights (S, Na), with the variance regularisation, before the
    hard-bound rejection (M,)."""
    S = post.S
    Kxa = np.stack([post.ks(s, Xa) for s in range(S)])          # (S, N, Na)
    invKzk = post.Binv @ Kxa
    _, f_s2a = post.predict(Xa)                                  # (S, Na)
    out = np.empty(Xs.shape[0])
    for i in range(0, Xs.shape[0], CAND_BLOCK):
        C = Xs[i:i + CAND_BLOCK]
        fmu, fs2 = post.predict(C)
        _, vtot = summary(fmu, fs2)
        sn2c = nearest_noise(post, C)
        ln_int = np.empty((S, C.shape[0]))
        for s in range(S):
            cov = (kernel(post.ell[s], post.sf2[s], C, Xa)
                   - post.ks(s, C).T @ invKzk[s])                # (M, Na)
            red = cov ** 2 / (fs2[s] + sn2c)[:, None]
            s2p = np.maximum(f_s2a[s][None, :] - red, 1e-12)
            x = U_IQR * np.sqrt(s2p)
            ln_sinh = x + np.log1p(-np.exp(-2.0 * x))           # log 2 sinh
            ln_int[s] = _logsumexp(ln_weights[s][None, :] + ln_sinh, 1)
        acq = _logsumexp(ln_int, 0) - math.log(S)
        ratio = tol_var / np.maximum(vtot, np.finfo(float).tiny)
        out[i:i + CAND_BLOCK] = np.where(vtot < tol_var, acq + ratio - 1.0,
                                         acq)
    return out
