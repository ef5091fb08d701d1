"""End-to-end training driver for the ported architectures.

Trains a (reduced or full) arch config on the run's device — the card
(:func:`repro_torch.get_device`; without one it raises unless
``repro_torch.set_device("cpu")`` was called) — with
``models.model.TrainStep``, the reference's ``jax.jit(make_train_step(...),
donate_argnums=(0,))``: the state is updated in place and, on the card,
the step is one CUDA graph (step 1 eager, step 2 captured, later steps
replayed).  The flags are
the reference's (``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b \\
        --full --layers 2 --steps 6 --batch 2 --seq 512

Synthetic LM data is the reference's fixed-transition Markov stream, the
same ``RandomState`` draws bit for bit (learnable: the loss should fall
well below log(vocab)).  Parameters are drawn from ``--seed`` on the run's
device.  Checkpoints (``--ckpt-dir``) are the reference's msgpack format.
``REPRO_FLASH_ATTN=1`` (or ``models.attention.set_flash_attention``) runs
attention through the flash kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_arch, list_archs
from repro_torch.convert import params_to_numpy
from repro_torch.models.model import Model, TrainStep, init_train_state
from repro_torch.optim import get_optimizer
from repro_torch.tracking import Tracker
from repro_torch.utils.tree import tree_leaves


def synthetic_lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                         device=None):
    """Markov chain over a vocab-sized ring: next = cur + step (mod vocab),
    with a noisy step distribution — enough structure to verify learning.
    Yields ``{"tokens": (batch, seq) int64}`` on ``device``."""
    rng = np.random.RandomState(seed)
    steps = rng.randint(1, 7, size=vocab)
    while True:
        start = rng.randint(0, vocab, size=(batch, 1))
        seqs = [start]
        cur = start
        for _ in range(seq - 1):
            jump = steps[cur % vocab] + (rng.rand(*cur.shape) < 0.1)
            cur = (cur + jump.astype(np.int64)) % vocab
            seqs.append(cur)
        yield {"tokens": torch.from_numpy(
            np.concatenate(seqs, axis=1).astype(np.int64)).to(device)}


def main(argv=None):
    """Train; returns the per-step losses (floats)."""
    from repro_torch.kernels.ops import get_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    # size overrides on top of the config (e.g. a ~100M-param run:
    # --d-model 768 --layers 12 --d-ff 2048 --vocab 32000)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, reduced=args.reduced)
    over = {}
    if args.d_model:
        over["d_model"] = args.d_model
        over["n_heads"] = max(1, args.d_model // 128)
        over["n_kv_heads"] = max(1, args.d_model // 128)
        over["head_dim"] = 0
    if args.layers:
        over["n_layers"] = args.layers
    if args.d_ff:
        over["d_ff"] = args.d_ff
    if args.vocab:
        over["vocab"] = args.vocab
    if over:
        cfg = dataclasses.replace(cfg, **over)
    device = torch.device(get_device())
    model = Model(cfg)
    opt = get_optimizer(args.optimizer, args.lr)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(model, opt, gen, device)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M devices=1 "
          f"device={device} ({name})")

    step_fn = TrainStep(model, opt)
    data = synthetic_lm_batches(cfg.vocab, args.batch, args.seq, args.seed,
                                device)
    tracker = Tracker()
    tracker.create_task(f"train_{cfg.name}", vars(args))

    t0 = time.perf_counter()
    losses = []
    frames = None
    if cfg.family in ("vlm", "audio"):
        # the frontend stubs' input: N(0, 1) from the run's generator, as
        # Model.make_inputs draws it.  The reference's driver feeds zeros,
        # and zero patches stay exact zeros through every VLM layer, where
        # RMSNorm's backward scales the gradient by 1/sqrt(eps) = 1000 a
        # layer: from 14 layers on it overflows to inf, and inf times the
        # zero activations makes the weight gradients NaN (in both
        # packages; ROADMAP queue 3).
        frames = torch.randn((args.batch, cfg.n_frames, cfg.d_model),
                             generator=gen, device=device).to(
                                 getattr(torch, cfg.dtype))
    for step in range(args.steps):
        batch = next(data)
        if frames is not None:
            batch["frames"] = frames
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if (step + 1) % args.log_every == 0:
            dt = time.perf_counter() - t0
            avg = float(np.mean(losses[-args.log_every:]))
            print(f"step {step+1:5d} loss {avg:.4f} "
                  f"({dt/ (step+1):.3f}s/step)")
            tracker.track_round(f"train_{cfg.name}", step, loss=avg,
                                sec_per_step=dt / (step + 1))
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, params_to_numpy(state.params),
                               args.steps)
        print("checkpoint:", path)
    first = float(np.mean(losses[:10]))
    last = float(np.mean(losses[-10:]))
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'LEARNED' if last < first - 0.2 else 'check lr/steps'})")
    return losses


if __name__ == "__main__":
    main()
