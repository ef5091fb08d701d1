"""Pytree checkpointing: msgpack files with atomic rename + step indexing.

The file format is the reference's (``repro.checkpoint.store``): one
``ckpt_{step:08d}.msgpack`` per step, written by
:mod:`repro_torch.comm.serialize`, so a checkpoint written by either
package loads in the other.

The tree is whatever the trainer considers its state — full model params,
or only the LoRA adapter tree under ``client.finetune = "lora"`` (the
frozen base is rebuilt from ``cfg.seed`` at resume, never persisted).
Tiered client state checkpoints tier-agnostically: the batched executor's
error-feedback store snapshots every residual row — device-resident *and*
host-spilled — per client (``BatchedExecutor.ef_state``), so a run that
spilled cold clients to the host resumes bit-identically to one that never
did, whatever either side's device-tier capacity."""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

from repro_torch.comm import serialize


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt_{step:08d}.msgpack")


def save_checkpoint(ckpt_dir: str, tree: Any, step: int,
                    keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    _sweep_tmp(ckpt_dir)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        serialize.dump(tree, f)
    final = _path(ckpt_dir, step)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _sweep_tmp(ckpt_dir: str) -> None:
    """Remove stale ``*.tmp`` files of saves killed before their atomic
    rename.  Only run from ``save_checkpoint`` (single writer), so no live
    temp file can be swept."""
    for fn in os.listdir(ckpt_dir):
        if fn.endswith(".tmp"):
            try:
                os.remove(os.path.join(ckpt_dir, fn))
            except OSError:
                pass               # concurrent sweep/replace already won


def available_steps(ckpt_dir: str) -> list:
    """Sorted step numbers of every checkpoint in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for fn in os.listdir(ckpt_dir)
                  if (m := re.match(r"ckpt_(\d+)\.msgpack$", fn)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> Any:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = _path(ckpt_dir, step)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no checkpoint for step {step} in {ckpt_dir}; available "
            f"steps: {available_steps(ckpt_dir) or 'none'}")
    with open(path, "rb") as f:
        return serialize.loads(f.read())


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in available_steps(ckpt_dir)[:-keep] if keep else []:
        os.remove(_path(ckpt_dir, s))
