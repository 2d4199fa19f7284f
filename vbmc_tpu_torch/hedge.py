"""Exp3-style hedging over a portfolio of acquisition functions
(cf. `private/acqhedge_vbmc.m`; off by default, enabled with
options.acq_hedge when several acquisitions are configured). A copy of
`vbmc_tpu/hedge.py`, unchanged in behaviour."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AcqHedge:
    names: list
    beta: float = 1.0
    decay: float = 0.9
    lapse: float = 0.0
    g: np.ndarray = None
    chosen: int = 0

    def __post_init__(self):
        if self.g is None:
            self.g = np.zeros(len(self.names))

    def choose(self, rng) -> str:
        """Softmax + lapse selection (`acqhedge_vbmc.m:8-26`)."""
        n = len(self.names)
        gmax = self.g.max()
        p = np.exp(self.beta * (self.g - gmax))
        p = p / p.sum()
        p = p * (1 - n * self.lapse) + self.lapse
        self.chosen = int(rng.choice(n, p=p / p.sum()))
        return self.names[self.chosen]

    def update(self, elbo_impro: float, func_evals: int = 1):
        """Reward the chosen arm by the (clipped) ELCBO improvement and decay
        all arms (`acqhedge_vbmc.m:28-56`)."""
        self.g *= self.decay ** func_evals
        reward = float(np.clip(elbo_impro, 0.0, 1.0))
        self.g[self.chosen] += reward
        self.g = np.maximum(self.g, -10.0)
