"""vbmc_tpu_torch: VBMC in PyTorch, for one NVIDIA H100: the noiseless main
path and the noisy-target path.

A port of `vbmc_tpu` (the JAX reference, which stays beside it). The
package imports torch and numpy, never jax and nothing of `vbmc_tpu`: the
host-side modules it shares with the reference in behaviour (`options`,
`state`, `hedge`, `gp.config`) are its own copies. `vbmc` runs on the card
unless the caller passes ``device="cpu"``.

The acquisition sweep of every acquired point runs as a hand-written CUDA
kernel on CUDA tensors (`kernels.py`: `csrc/prospective_acq.cu` for
noiseless targets, `csrc/viqr_acq.cu` for noisy ones); on CPU tensors the
same wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"

_LAZY = {
    "vbmc": "vbmc_tpu_torch.main",
    "VBMCResult": "vbmc_tpu_torch.main",
    "VBMCOptions": "vbmc_tpu_torch.options",
    "VariationalPosterior": "vbmc_tpu_torch.vp",
    "vp_rnd": "vbmc_tpu_torch.vp",
    "vp_moments": "vbmc_tpu_torch.vp",
    "vp_kldiv": "vbmc_tpu_torch.vp",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(_LAZY[name])
        return getattr(mod, name)
    raise AttributeError(f"module 'vbmc_tpu_torch' has no attribute {name!r}")
