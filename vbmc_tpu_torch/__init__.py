"""vbmc_tpu_torch: VBMC in PyTorch, for one NVIDIA H100, with the public
surface of the JAX package: `vbmc`, the posterior queries, the multi-run
diagnostics, serialization, the run sweep and the command line
(``python -m vbmc_tpu_torch``).

A port of `vbmc_tpu` (the JAX reference, which stays beside it). The
package imports torch and numpy, never jax and nothing of `vbmc_tpu`: the
host-side modules it shares with the reference in behaviour (`options`,
`state`, `hedge`, `gp.config`, `utils.kde`, `utils.ibs`) are its own copies.
`vbmc` runs on the card unless the caller passes ``device="cpu"``; the
queries run on the device of the VP or GP they are given.

The acquisition sweep of every acquired point runs as a hand-written CUDA
kernel on CUDA tensors (`kernels.py`: `csrc/prospective_acq.cu` for
noiseless targets, `csrc/viqr_acq.cu` for noisy ones); on CPU tensors the
same wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

_LAZY = {
    "Trinfo": "vbmc_tpu_torch.transforms",
    "create_trinfo": "vbmc_tpu_torch.transforms",
    "VBMCOptions": "vbmc_tpu_torch.options",
    "VariationalPosterior": "vbmc_tpu_torch.vp",
    "vp_rnd": "vbmc_tpu_torch.vp",
    "vp_pdf": "vbmc_tpu_torch.vp",
    "vp_moments": "vbmc_tpu_torch.vp",
    "vp_mode": "vbmc_tpu_torch.vp",
    "vp_kldiv": "vbmc_tpu_torch.vp",
    "vp_mtv": "vbmc_tpu_torch.vp",
    "vp_power": "vbmc_tpu_torch.vp",
    "is_valid_vp": "vbmc_tpu_torch.vp",
    "vbmc": "vbmc_tpu_torch.main",
    "VBMCResult": "vbmc_tpu_torch.main",
    "vbmc_diagnostics": "vbmc_tpu_torch.diagnostics",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name])
        return getattr(mod, name)
    raise AttributeError(f"module 'vbmc_tpu_torch' has no attribute {name!r}")
