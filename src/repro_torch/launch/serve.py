"""Batched decode serving driver (the production-phase inference path).

Randomly initializes an arch from ``--seed`` (drawn on the run's
device), prefills a prompt batch by stepping the decoder over it, then
serves greedy autoregressive decode steps against the cache — the
reference's ``repro.launch.serve`` on the port's ``make_serve_step``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
        --full --batch 16 --prompt-len 32 --gen 32

It runs on the CUDA card; ``repro_torch.set_device("cpu")`` before
:func:`main` runs it on the CPU.  The prompt and the greedy tokens go
through one serve step (``make_serve_step``): on the card one CUDA graph
for every position — the first call eager (the warm-up), the second
captured, the rest replayed — whose counts the run prints before its
sample; on the CPU every step runs eagerly.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels.ops import get_device
from repro_torch.models.model import Model, make_serve_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--ring", action="store_true",
                    help="sliding-window cache (long-context mode)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch, reduced=args.reduced)
    model = Model(cfg)
    device = get_device()
    # params and prompt drawn on the run's device, as launch.train draws
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)
    serve = make_serve_step(model, ring=args.ring)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    B = args.batch
    # an encoder-decoder model's enc_kv stays the zeros of init_cache (a
    # stand-in for an encoded prompt, as in the reference's driver)
    cache = model.init_cache(B, args.cache_len, ring=args.ring, device=device)
    prompt = torch.randint(0, cfg.vocab, (B, args.prompt_len),
                           generator=gen, device=device)

    # prefill by stepping the decoder over the prompt (serving-path prefill)
    sync()
    t0 = time.perf_counter()
    for p in range(args.prompt_len):
        logits, cache = serve(params, cache, prompt[:, p:p + 1], p)
    sync()
    prefill_s = time.perf_counter() - t0

    # greedy decode
    t1 = time.perf_counter()
    out_tokens = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for i in range(args.gen):
        logits, cache = serve(params, cache, tok, args.prompt_len + i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out_tokens.append(tok[:, 0])
    gen_tokens = torch.stack(out_tokens, dim=1).cpu().numpy()
    decode_s = time.perf_counter() - t1

    toks_per_s = args.gen * B / decode_s
    print(f"arch={cfg.name} batch={B} prompt={args.prompt_len} "
          f"gen={args.gen} ring={args.ring}")
    print(f"prefill {prefill_s:.2f}s | decode {decode_s:.2f}s "
          f"({toks_per_s:.1f} tok/s aggregate)")
    print(f"serve step on {device.type}: captures {serve.captures}, "
          f"recaptures {serve.recaptures}, replays {serve.replays}, eager "
          f"steps {serve.eager_steps}")
    print("sample:", gen_tokens[0][:16].tolist())
    return gen_tokens


if __name__ == "__main__":
    main()
