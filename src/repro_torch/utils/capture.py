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

A capture fails when another thread works on the card meanwhile
(``capture_error_mode="global"``), and a replay's sync-debug mode is
process-wide, so another thread's legitimate host sync during a replay
raises: callers that run captured programs from several threads hold
:func:`device_lock` around each thread's work on the device.

What a capture records depends on the flags the model's Python code reads
as it runs (:func:`traced_flags`: the flash-attention switch), so every
caller puts them in the key its graph is valid for: a flag flipped after
a capture selects another key, which warms up and captures anew.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict

import torch

from repro_torch.utils.tree import (
    tree_flatten, tree_leaves, tree_map, tree_unflatten,
)


_LOCKS: Dict[torch.device, threading.RLock] = {}
_LOCKS_GUARD = threading.Lock()


def device_lock(device) -> threading.RLock:
    """The one re-entrant lock of ``device`` in this process: held around
    a thread's work on the device, it keeps every other thread's off the
    device during a capture or a replay."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _LOCKS_GUARD:
        return _LOCKS.setdefault(device, threading.RLock())


def traced_flags():
    """The process-wide flags that choose, while a program runs, which
    kernels it launches (``models.attention.use_flash_attention``): part
    of every captured program's key."""
    from repro_torch.models.attention import use_flash_attention

    return (use_flash_attention(),)


class CaptureCounts:
    """Captures and replays of one kind of captured program in this
    process."""

    def __init__(self):
        self.captures = 0
        self.replays = 0


class CapturedGraph:
    """``run(inputs)`` as one CUDA graph on ``device``; ``counts`` gets one
    capture now and one replay a call.  ``inputs`` is a tree whose leaves
    are tensors (copied into the static buffers) or None.  ``pool``: the
    memory pool of another graph (:meth:`pool`) that this one shares, for
    graphs that never replay at once and whose callers copy their outputs
    out before the next replay of any of them, as :meth:`__call__` does;
    None, a private pool."""

    def __init__(self, run: Callable, inputs, device: torch.device,
                 counts: CaptureCounts, pool=None):
        from repro_torch.kernels import ops as kops

        leaves, self._treedef = tree_flatten(inputs)
        self._static = [None if t is None else t.clone() for t in leaves]
        static = tree_unflatten(self._treedef, self._static)
        self._counts = counts
        self.graph = torch.cuda.CUDAGraph()
        before = kops.launch_counts()
        try:
            with torch.cuda.device(device), torch.cuda.graph(
                    self.graph, pool=pool, capture_error_mode="global"):
                self._out = run(static)
        finally:
            after = kops.launch_counts()
            # nothing ran on the card yet: the replays count the launches
            self.launches = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}
            kops.add_launch_counts({k: -n for k, n in self.launches.items()})
        counts.captures += 1

    def pool(self):
        """The handle of this graph's memory pool."""
        return self.graph.pool()

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
