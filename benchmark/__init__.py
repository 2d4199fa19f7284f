"""The benchmark of `vbmc_tpu_torch` on one NVIDIA GPU (see `run.py`)."""
