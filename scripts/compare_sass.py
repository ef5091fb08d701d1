"""Compare the SASS of one kernel source's template instances between two
source trees: whether an edit left some instances' machine code unchanged.

    python3 scripts/compare_sass.py --source flash_attn --old DIR \\
        [--new DIR] [--match 'flash_(?:fwd|dq|dkv)_kernel'] [--dims 16,32,64,128]

compiles ``DIR/src/repro_torch/kernels/csrc/<source>.cu`` of each tree
with this checkout's ``nvcc`` flags, dumps each library's SASS with
``cuobjdump`` and prints, for every instance ``<kernel><N>`` whose name
matches ``--match`` and whose first template argument is in ``--dims``,
its instruction count in each tree and whether the instruction text is
identical (addresses, encodings and the anonymous namespace's hash left
out).  Needs the CUDA toolkit (the machine with the card).
"""
import argparse
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_name(symbol):
    """(name, first template argument) of a mangled kernel symbol, its
    namespaces (the anonymous one's hash differs between trees) left out:
    ``_ZN<n><namespace>...<n><name>ILi<N>E...``; None for another form."""
    m = re.match(r"_ZN?", symbol)
    i, name = m.end() if m else 0, None
    while m and (m := re.match(r"\d+", symbol[i:])):
        n, i = int(m.group()), i + m.end()
        name, i = symbol[i:i + n], i + n
    t = re.match(r"ILi(\d+)E", symbol[i:])
    return (name, t.group(1)) if name and t else None


def sass(nvcc, flags, src, match):
    """{"<kernel><N>": [instruction text]} of ``src`` compiled, for each
    kernel whose whole name matches ``match``."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "lib.so")
        subprocess.run([nvcc, *flags, "-o", lib, src], check=True)
        text = subprocess.run([cuobjdump, "--dump-sass", lib],
                              capture_output=True, text=True,
                              check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            cur = (f"{name[0]}<{name[1]}>" if name and
                   re.fullmatch(match, name[0]) else None)
            if cur:
                funcs[cur] = []
        elif cur and "/*" in line and ";" in line:
            body = line.split("*/", 1)[1].rsplit("/*", 1)[0].strip()
            funcs[cur].append(re.sub(r"_GLOBAL__N__\w+", "ANON", body))
    return funcs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", required=True)
    ap.add_argument("--old", required=True)
    ap.add_argument("--new", default=HERE)
    ap.add_argument("--match", default=r"\w+_kernel")
    ap.add_argument("--dims", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import build

    nvcc, flags = build.nvcc_path(), list(build.NVCC_FLAGS)
    trees = [sass(nvcc, flags, os.path.join(root, "src", "repro_torch",
                                            "kernels", "csrc",
                                            f"{args.source}.cu"), args.match)
             for root in (args.old, args.new)]
    dims = {d for d in args.dims.split(",") if d}
    same = True
    for name in sorted(trees[0]):
        if dims and name.split("<")[1].rstrip(">") not in dims:
            continue
        old, new = trees[0][name], trees[1].get(name)
        same &= old == new
        print(f"{name}: old {len(old)} instructions, new "
              f"{len(new or [])}, identical {old == new}")
    print(f"all identical: {same}")


if __name__ == "__main__":
    main()
