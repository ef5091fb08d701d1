"""Time the port's flash-attention kernels (K6 forward, K7a dQ, K7b dK/dV)
of one source tree at the GLM-4 LoRA path's shape, beside fp32 SDPA.

    python3 scripts/bench_flash.py [--root DIR]

imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its ``flash_attn`` kernels into ``DIR/build/kernels``, and prints the card
(``nvidia-smi`` name and power limit) and one JSON line: milliseconds of
each kernel and of fp32 ``scaled_dot_product_attention`` at BH 512 (4
clients x 4 sequences x 32 heads), S 512, D 128, causal, with TF32 off.
The timing (``cuda_ms``: median of CUDA events) and the SDPA yardstick
(``sdpa_ms``) are this checkout's ``chip_smoke.py`` phase 3b's, whatever
tree ``DIR`` holds, so the numbers compare with its kernel table.  To compare
two trees on one card, unpack one (``git archive``) into a directory that
``.gitignore`` lists and run, in one call on the card: parent, change,
change, parent.  Needs a CUDA card.
"""
import argparse
import json
import math
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (512, 512, 128)      # BH, S, D of the LoRA path (chip_smoke.py 3b)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("bench_flash.py needs a CUDA card")
    sys.path.insert(0, HERE)
    from chip_smoke import cuda_ms, sdpa_ms     # puts HERE/src on the path
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(root, "build",
                                                       "kernels")
    from repro_torch.kernels import attention, build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    build.build_all(["flash_attn"])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4321)
    q, k, v, do = (torch.randn(SHAPE, generator=gen, device=dev)
                   for _ in range(4))
    o, lse = attention.flash_fwd(q, k, v, True)
    delta = (do * o).sum(dim=-1)
    res = {
        "root": os.path.relpath(root),
        "repro_torch": os.path.relpath(attention.__file__),
        "shape": list(SHAPE), "causal": True,
        "flash_fwd": cuda_ms(lambda: attention.flash_fwd(q, k, v, True)),
        "flash_dq": cuda_ms(lambda: attention.flash_dq(
            q, k, v, do, lse, delta, True)),
        "flash_dkv": cuda_ms(lambda: attention.flash_dkv(
            q, k, v, do, lse, delta, True)),
    }
    res["sdpa_fwd"], res["sdpa_bwd"] = sdpa_ms(q, k, v, do)
    assert all(math.isfinite(x) for x in res.values()
               if isinstance(x, float))
    print(json.dumps(res))


if __name__ == "__main__":
    main()
