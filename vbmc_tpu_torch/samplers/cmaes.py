"""Batched CMA-ES for acquisition refinement (cf.
`vbmc_tpu/samplers/cmaes.py`, `utils/cmaes_modded.m`).

(mu/mu_w, lambda)-CMA-ES with rank-1, rank-mu and active (negative)
covariance updates; each generation's population is one batched objective
call, for ceil(max_evals / lambda) generations.

A generation (`CMAES.generation`) reads and updates a fixed set of tensors
in place (the mean, step size, covariance, evolution paths, best point and
the generation index) and never waits for the device: the step size and
the hsig switch are 0-d tensors, the D x D eigendecomposition is
`kernels.sym_eig`, and the normals of every generation are drawn up front.
On CUDA tensors generation 0 runs eagerly on a side stream, generation 1
is captured as a CUDA graph (`graphs.Graph`), and the graph is replayed for
the other n_gen - 1 generations: one launch a generation in place of a few
hundred, and no host sync until the result is read. CPU tensors run the
same function n_gen times. A host sync inside the objective makes the
capture raise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from vbmc_tpu_torch.graphs import Graph
from vbmc_tpu_torch.kernels import sym_eig
from vbmc_tpu_torch.tracing import span


@dataclasses.dataclass
class CMAESResult:
    x_best: torch.Tensor
    f_best: torch.Tensor
    x_mean: torch.Tensor
    n_evals: int


class CMAES:
    """One CMA-ES run of f_batch((lam, D) -> (lam,)) from x0 with
    per-dimension scales sigma0, inside [lb, ub]: `start` runs generation 0
    (and on CUDA captures generation 1), `finish` the other n_gen - 1 and
    returns `result`; `generation` is one generation, in place. ``f0``,
    x0's own value where it is known, is the best to beat: the best point
    stays x0 unless a generation finds a lower value."""

    def __init__(self, gen: torch.Generator, f_batch: Callable,
                 x0: torch.Tensor, sigma0: torch.Tensor, lb: torch.Tensor,
                 ub: torch.Tensor, max_evals: int,
                 popsize: int | None = None,
                 f0: torch.Tensor | None = None):
        D = x0.shape[0]
        dt, dev = x0.dtype, x0.device
        lam = popsize if popsize is not None \
            else 4 + int(3 * math.log(max(D, 2)))
        mu = lam // 2
        ar = torch.arange(1, 2 * mu + 1, dtype=torch.float64)
        w = math.log(mu + 0.5) - torch.log(ar[:mu])
        w = w / w.sum()
        mueff = float(1.0 / (w ** 2).sum())

        cc = (4 + mueff / D) / (D + 4 + 2 * mueff / D)
        cs = (mueff + 2) / (D + mueff + 5)
        c1 = 2 / ((D + 1.3) ** 2 + mueff)
        cmu = min(1 - c1, 2 * (mueff - 2 + 1 / mueff) / ((D + 2) ** 2 + mueff))
        damps = 1 + 2 * max(0.0, math.sqrt((mueff - 1) / (D + 1)) - 1) + cs
        chiN = math.sqrt(D) * (1 - 1 / (4 * D) + 1 / (21 * D ** 2))

        # Active CMA: negative weights for the worst mu samples, scaled to
        # keep C positive definite (the reference runs CMA.active=1).
        w_neg_raw = math.log(mu + 0.5) - torch.log(ar[mu:])
        w_neg_raw = w_neg_raw - w_neg_raw.max()
        mueff_neg = float(w_neg_raw.sum() ** 2
                          / max(float((w_neg_raw ** 2).sum()), 1e-12))
        a_mu = 1.0 + c1 / max(cmu, 1e-12)
        a_mueff = 1.0 + 2.0 * mueff_neg / (mueff + 2.0)
        a_posdef = (1.0 - c1 - cmu) / (D * max(cmu, 1e-12))
        neg_scale = min(a_mu, a_mueff, a_posdef)
        w_neg = w_neg_raw / max(-float(w_neg_raw.sum()), 1e-12) * neg_scale

        self.f_batch = f_batch
        self.D, self.lam, self.mu = D, lam, mu
        self.cc, self.cs, self.c1, self.cmu = cc, cs, c1, cmu
        self.damps, self.chiN = damps, chiN
        self.c_ps = math.sqrt(cs * (2 - cs) * mueff)
        self.c_pc = math.sqrt(cc * (2 - cc) * mueff)
        self.w = w.to(dev, dt)
        self.w_neg = w_neg.to(dev, dt)
        self.n_gen = max(int(math.ceil(max_evals / lam)), 1)
        self.x0, self.lb, self.ub = x0, lb, ub
        self.scale = sigma0.clamp_min(1e-12)
        self.Z = torch.randn((self.n_gen, lam, D), generator=gen, device=dev,
                             dtype=dt)
        self.k = torch.zeros(1, dtype=torch.long, device=dev)
        self.m = torch.zeros(D, dtype=dt, device=dev)
        self.sigma = torch.ones((), dtype=dt, device=dev)
        self.C = torch.eye(D, dtype=dt, device=dev)
        self.ps = torch.zeros(D, dtype=dt, device=dev)
        self.pc = torch.zeros(D, dtype=dt, device=dev)
        self.x_best = x0.clone()
        self.f_best = torch.full((), torch.finfo(dt).max, dtype=dt,
                                 device=dev) if f0 is None \
            else f0.to(dev, dt).reshape(()).clone()
        self._graph = None

    def generation(self):
        """Generation k: sample, evaluate, update every state tensor in
        place, k += 1."""
        evals, B = sym_eig(self.C)
        Dd = evals.clamp_min(1e-20).sqrt()
        Z = self.Z.index_select(0, self.k)[0]
        Y = (Z * Dd[None, :]) @ B.T                     # N(0, C)
        xs = torch.minimum(torch.maximum(
            self.x0 + (self.m[None, :] + self.sigma * Y) * self.scale,
            self.lb), self.ub)
        fs = self.f_batch(xs)
        fs = torch.where(torch.isfinite(fs), fs, torch.finfo(fs.dtype).max)
        order = torch.argsort(fs)
        Y_sorted = Y.index_select(0, order)
        top, bot = Y_sorted[:self.mu], Y_sorted[self.lam - self.mu:]
        y_w = self.w @ top
        self.m.add_(self.sigma * y_w)

        self.ps.mul_(1 - self.cs).add_(B @ ((B.T @ y_w) / Dd),
                                       alpha=self.c_ps)
        ps_norm = torch.linalg.vector_norm(self.ps)
        self.sigma.copy_(torch.clamp(self.sigma * torch.exp(
            (self.cs / self.damps) * (ps_norm / self.chiN - 1)), 1e-12, 1e6))
        hsig = (ps_norm / math.sqrt(1 - (1 - self.cs) ** 2) / self.chiN
                < (1.4 + 2 / (self.D + 1))).to(y_w.dtype)
        self.pc.mul_(1 - self.cc).add_(hsig * self.c_pc * y_w)
        rank_mu = torch.einsum("i,ij,ik->jk", self.w, top, top)
        maha2 = (((bot @ B) / Dd[None, :]) ** 2).sum(1)
        Y_hat = bot * torch.sqrt(self.D / maha2.clamp_min(1e-12))[:, None]
        rank_neg = torch.einsum("i,ij,ik->jk", -self.w_neg, Y_hat, Y_hat)
        upd = self.c1 * torch.outer(self.pc, self.pc) \
            + self.cmu * (rank_mu - rank_neg)
        C = (1 - self.c1 - self.cmu) * self.C + upd
        self.C.copy_(0.5 * (C + C.T))

        first = order[:1]
        f0 = fs.index_select(0, first)[0]
        better = f0 < self.f_best
        self.x_best.copy_(torch.where(better, xs.index_select(0, first)[0],
                                      self.x_best))
        self.f_best.copy_(torch.where(better, f0, self.f_best))
        self.k.add_(1)

    def start(self):
        """Generation 0. On CUDA with more generations to come it runs on
        the device's side stream, then generation 1 is captured there as a
        graph (recorded, not run) and instantiated (`graphs.Graph`)."""
        if self.x0.device.type != "cuda" or self.n_gen == 1:
            self.generation()
            return
        self._graph = Graph(self.generation, self.x0.device)

    def finish(self) -> CMAESResult:
        """Generations 1 to n_gen - 1 (the graph's replays on CUDA), then
        `result`."""
        for _ in range(self.n_gen - 1):
            if self._graph is None:
                self.generation()
            else:
                self._graph.replay()
        return self.result()

    def result(self) -> CMAESResult:
        """The best point and value so far, the mean, and the evaluations
        of the whole run, on the device."""
        x_mean = torch.minimum(torch.maximum(self.x0 + self.m * self.scale,
                                             self.lb), self.ub)
        return CMAESResult(x_best=self.x_best, f_best=self.f_best,
                           x_mean=x_mean, n_evals=self.n_gen * self.lam)


def cmaes_minimize(gen: torch.Generator, f_batch: Callable, x0: torch.Tensor,
                   sigma0: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor,
                   max_evals: int, popsize: int | None = None,
                   f0: torch.Tensor | None = None) -> CMAESResult:
    """Minimise f_batch((lam, D) -> (lam,)) from x0 with per-dimension
    scales sigma0, for ceil(max_evals / lam) generations: `CMAES`, started
    in the span "capture" and finished in the span "replay", which ends
    once the result is on the host (the copy waits for the replays). ``f0``:
    x0's own value, the best to beat, where it is known."""
    es = CMAES(gen, f_batch, x0, sigma0, lb, ub, max_evals, popsize, f0)
    with span("capture"):
        es.start()
    with span("replay"):
        res = es.finish()
        D = x0.shape[0]
        host = torch.cat([res.x_best, res.f_best[None], res.x_mean]).cpu()
    return CMAESResult(x_best=host[:D], f_best=host[D], x_mean=host[D + 1:],
                       n_evals=res.n_evals)
