"""A device program as one CUDA graph: the port's counterpart of a
``jax.jit`` program that the reference compiles once and calls again.

:class:`CapturedGraph` is the one capture mechanism of the port; the fused
round (``core/batched.py::CapturedRound``) and the serve step
(``models/model.py::ServeStep``) both use it, each with counters of its
own (:class:`CaptureCounts`).

Capturing copies the tensor leaves of a call's inputs into static buffers,
captures ``run(static inputs)`` with ``torch.cuda.graph(...,
capture_error_mode="global")`` into the graph's private memory pool (a
call that synchronizes with the host fails the capture; entering it
synchronizes the device and empties the allocator's cache, so the pool of
a graph dropped just before goes back to the device) and records the
kernel launches the capture made, per kernel.  Whatever else ``run``
reads or writes — parameters, a KV cache, an error-feedback store — it
reads and writes in the caller's own storage, so a caller keys its graph
on that storage and captures again when it moves.

Calling the graph copies a call's inputs into the static buffers (a
tensor with ``copy_``, a Python number with ``fill_``: neither waits for
the device), replays it under ``torch.cuda.set_sync_debug_mode("error")``
(a replay that synchronizes with the host raises), adds the recorded
launches to ``kernels.ops.launch_counts`` (the wrappers count in Python,
which a replay skips) and returns a copy of the outputs, so that nothing
the caller keeps aliases a buffer the next replay overwrites.  A capture
or replay that fails raises with its cause; nothing falls back to an
eager call.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.utils.tree import (
    tree_flatten, tree_leaves, tree_map, tree_unflatten,
)


class CaptureCounts:
    """Captures and replays of one kind of captured program in this
    process."""

    def __init__(self):
        self.captures = 0
        self.replays = 0


class CapturedGraph:
    """``run(inputs)`` as one CUDA graph on ``device``; ``counts`` gets one
    capture now and one replay a call.  ``inputs`` is a tree whose leaves
    are tensors (copied into the static buffers) or None."""

    def __init__(self, run: Callable, inputs, device: torch.device,
                 counts: CaptureCounts):
        from repro_torch.kernels import ops as kops

        leaves, self._treedef = tree_flatten(inputs)
        self._static = [None if t is None else t.clone() for t in leaves]
        static = tree_unflatten(self._treedef, self._static)
        self._counts = counts
        self.graph = torch.cuda.CUDAGraph()
        before = kops.launch_counts()
        try:
            with torch.cuda.device(device), torch.cuda.graph(
                    self.graph, capture_error_mode="global"):
                self._out = run(static)
        finally:
            after = kops.launch_counts()
            # nothing ran on the card yet: the replays count the launches
            self.launches = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
            kops.add_launch_counts({k: -n for k, n in self.launches.items()})
        counts.captures += 1

    def __call__(self, inputs):
        from repro_torch.kernels import ops as kops

        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for buf, t in zip(self._static, tree_leaves(inputs)):
                if buf is None:
                    continue
                if isinstance(t, torch.Tensor):
                    buf.copy_(t)
                else:
                    buf.fill_(t)
            self.graph.replay()
            out = tree_map(lambda t: None if t is None else t.clone(),
                           self._out)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        kops.add_launch_counts(self.launches)
        self._counts.replays += 1
        return out
