"""Metropolis-adjusted Langevin (MALA) sampler with step-size adaptation
(cf. `vbmc_tpu/samplers/mala.py`, `utils/malasample_vbmc.m`): one chain of
fixed length, the step size pushed after every step toward the target
acceptance rate.
"""

from __future__ import annotations

from typing import Callable

import torch


def mala_sample(gen: torch.Generator, logpdf_and_grad: Callable,
                x0: torch.Tensor, n_samples: int, step0: float = 0.1,
                burn: int = 0, thin: int = 1, target_accept: float = 0.574,
                adapt_rate: float = 0.05):
    """Run one MALA chain from x0 (D,) on x0's device; returns (samples
    (n_samples, D), logps (n_samples,), final step size).

    ``logpdf_and_grad(x) -> (logp, grad)`` takes and returns tensors; a
    gradient by autograd serves (`optim.value_and_grad`)."""
    D = x0.shape[0]
    dev, dt = x0.device, x0.dtype
    total = burn + n_samples * thin
    x = x0.clone()
    lp, g = logpdf_and_grad(x)
    lp = torch.as_tensor(lp, device=dev, dtype=dt)
    eps = torch.tensor(step0, device=dev, dtype=dt)
    xs = torch.empty((total, D), device=dev, dtype=dt)
    lps = torch.empty(total, device=dev, dtype=dt)
    for n in range(total):
        noise = torch.randn(D, generator=gen, device=dev, dtype=dt)
        prop = x + 0.5 * eps ** 2 * g + eps * noise
        lp_p, g_p = logpdf_and_grad(prop)
        lp_p = torch.as_tensor(lp_p, device=dev, dtype=dt)
        # proposal densities q(prop | x) and q(x | prop)
        fwd = -((prop - x - 0.5 * eps ** 2 * g) ** 2).sum() / (2 * eps ** 2)
        rev = -((x - prop - 0.5 * eps ** 2 * g_p) ** 2).sum() / (2 * eps ** 2)
        log_alpha = lp_p + rev - lp - fwd
        u = torch.rand((), generator=gen, device=dev, dtype=dt)
        ok = ((torch.log(u) < log_alpha) & torch.isfinite(g_p).all()
              & torch.isfinite(lp_p))
        x = torch.where(ok, prop, x)
        lp = torch.where(ok, lp_p, lp)
        g = torch.where(ok, g_p, g)
        eps = (eps * torch.exp(adapt_rate * (ok.to(dt) - target_accept))
               ).clamp(1e-6, 1e3)
        xs[n] = x
        lps[n] = lp
    sel = burn + thin * torch.arange(n_samples, device=dev) + (thin - 1)
    return xs[sel], lps[sel], eps
