"""Run-level parallelism: independent VBMC runs in worker processes."""
