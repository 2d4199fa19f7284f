"""One CUDA graph a call: the capture and replay that the samplers and the
L-BFGS share.

A sampler or an optimiser whose step reads and writes a fixed set of
tensors in place, and never waits for the device, hands that step to
`Graph`. The step runs once
for real on the device's side stream (the warm-up that cuBLAS, cuSOLVER and
the allocator need before a capture, and the call's first step), is then
captured there as a CUDA graph and instantiated, and each `Graph.replay`
launches what it recorded. A host sync inside the step makes the capture
raise; what other threads of the process do on the card meanwhile does not
touch it. The warm-up and the capture run the batched linear algebra through
cuSOLVER: MAGMA's batched Cholesky solve, PyTorch's choice on the card by
default, allocates device memory, which a capture refuses. A replay runs
what was recorded and consults no such setting.

The kernels' launch counters (`kernels.KERNELS`) count what a graph
launches at each replay, not at its capture, which runs nothing.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

# One side stream and one graph memory pool a device, for the process,
# shared by every captured step. The last graph is kept alive so that the
# pool lives from call to call: each capture reuses the blocks the previous
# one freed, and memory does not grow from point to point. A graph is
# replayed only within the call that captured it, so no two graphs of the
# pool are ever live at once.
_CAPTURE: dict = {}


def _capture_slot(device: torch.device) -> dict:
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _CAPTURE:
        _CAPTURE[idx] = dict(stream=torch.cuda.Stream(idx),
                             pool=torch.cuda.graph_pool_handle(), graph=None)
    return _CAPTURE[idx]


@contextlib.contextmanager
def _cusolver():
    """The batched linear algebra goes to cuSOLVER until the block ends."""
    before = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(before)


class Graph:
    """``step`` run once on ``device``'s side stream, then captured there
    as a CUDA graph (recorded, not run) and instantiated; `replay` runs it
    again on the current stream."""

    def __init__(self, step: Callable[[], None], device: torch.device):
        # imported here: the kernels' module imports the GP package, whose
        # training imports the samplers that import this module
        from vbmc_tpu_torch import kernels

        self._kernels = kernels
        slot = _capture_slot(device)
        side = slot["stream"]
        main = torch.cuda.current_stream(device)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        # capture_begin and capture_end, not the torch.cuda.graph context:
        # that one synchronises the device and empties the allocator's cache
        # on entry, which every call would pay for. The capture binds this
        # thread alone: in the default ("global") mode a copy or a sync that
        # another thread of the process makes on the card meanwhile (a sweep
        # loading its runs' results) breaks the capture and fails there too.
        with torch.cuda.stream(side), _cusolver():
            step()
            before = kernels.launch_counts()
            graph.capture_begin(pool=slot["pool"],
                                capture_error_mode="thread_local")
            try:
                step()
            finally:
                graph.capture_end()
        main.wait_stream(side)
        slot["graph"] = self.graph = graph
        # the capture launched nothing: each replay launches what it recorded
        self.launches = kernels.launch_counts(since=before)
        kernels.add_launches(self.launches, -1)

    def replay(self):
        self.graph.replay()
        self._kernels.add_launches(self.launches)
