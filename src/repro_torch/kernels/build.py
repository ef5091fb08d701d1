"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` into its
own shared library, loaded with :mod:`ctypes` — no PyTorch headers, so a
build takes seconds.  Libraries are built at first use, from the sources in
this checkout only, into ``build/kernels/`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides it); the file name carries a hash of
the source, of the shared headers (``csrc/*.cuh``) and of the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
:func:`build_all` compiles several sources with one ``nvcc`` process each,
all started together.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3`` and never
``--use_fast_math`` — the int8 round trip relies on an IEEE-rounded
division, the STC bisection on exactly rounded f32 arithmetic, and flash
attention and WKV6 on accurate ``expf`` / ``logf``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fedavg_agg", "stc_topk", "quant", "flash_attn", "wkv6")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_C = ctypes.c_int
#: C entry points of each library: name -> argtypes (all return an int,
#: the launch's ``cudaGetLastError()``)
SIGNATURES = {
    "fedavg_agg": {"fedavg_agg_segments_launch": (_P, _C, _P, _P, _I64,
                                                  _I64, _C, _P)},
    "stc_topk": {"stc_batched_launch": (_P, _P, _P, _I64, _I64,
                                        ctypes.c_float, _P)},
    "quant": {"int8_rowmax_launch": (_P, _P, _P, _P, _I64, _I64, _C, _C,
                                     _F, _C, _P),
              "int8_qdq_launch": (_P, _P, _P, _P, _I64, _I64, _P),
              "int8_quantize_launch": (_P, _P, _P, _I64, _C, _C, _P),
              "int8_dequantize_launch": (_P, _P, _P, _I64, _C, _P),
              "int8_kernel_info": (_C, _P)},
    "flash_attn": {
        "flash_fwd_launch": (_P,) * 5 + (_I64,) * 3 + (_F, _C, _P),
        "flash_dq_launch": (_P,) * 7 + (_I64,) * 3 + (_F, _C, _P),
        "flash_dkv_launch": (_P,) * 8 + (_I64,) * 3 + (_F, _C, _P),
        "flash_kernel_info": (_C, _I64, _P)},
    "wkv6": {"wkv6_launch": (_P,) * 8 + (_I64,) * 4 + (_P,),
             "wkv6_kernel_info": (_I64, _P)},
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()     # one build and one load a library
#: (device index, stream) -> its slot (:func:`stream_slot`)
_SLOTS: Dict[Tuple[int, int], int] = {}
_SLOT_LOCK = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py -> repository root
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the CUDA kernels are built from kernels/csrc at first use")


def library_path(name: str) -> Path:
    """The library of ``name``; its file name carries a hash of the source,
    of every header in ``csrc`` (``*.cuh``, which a source may include) and
    of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library of ``names`` (default: all), one
    ``nvcc`` per source, all started together.  Returns the seconds each
    build took (0.0 for a library that was already built)."""
    names = list(SOURCES if names is None else names)
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    for name in names:
        target = library_path(name)
        if target.exists():
            secs[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)      # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (built first if needed).  Thread-safe:
    threads that first use a library at once (the client services of
    remote training) build and load it once."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                path = library_path(name)
                if not path.exists():
                    build_all([name])
                lib = ctypes.CDLL(str(path))
                for fn, argtypes in SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = list(argtypes)
                    getattr(lib, fn).restype = ctypes.c_int
                _LIBS[name] = lib
    return lib


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device`` (a CUDA tensor's device, so its
    index is set) as a ``cudaStream_t``, for a launch.  The raw getter
    skips the ``Stream`` object that ``torch.cuda.current_stream(device)``
    builds on every call, the costliest step of a launch on the host
    (PERF.md gives both costs)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def stream_slot(device: torch.device, slots: int) -> int:
    """A small number for ``device``'s current stream, the same at every
    call on that stream and distinct among the streams of one device: the
    index of state that a kernel keeps in device memory a stream (K3a's
    arrival counters, ``csrc/quant.cu``), so that launches that may run at
    once, on two streams, never share it.  Raises past ``slots`` streams
    of one device."""
    key = (device.index, stream(device))
    slot = _SLOTS.get(key)
    if slot is None:
        with _SLOT_LOCK:
            slot = _SLOTS.get(key)
            if slot is None:
                slot = sum(1 for k in _SLOTS if k[0] == device.index)
                if slot >= slots:
                    raise RuntimeError(
                        f"more than {slots} streams of {device} launched a "
                        f"kernel with per-stream state")
                _SLOTS[key] = slot
    return slot


def launch(device: torch.device, what: str, fn, *args) -> None:
    """Call the C launcher ``fn(*args, stream)`` with ``device`` (a CUDA
    tensor's) the current device and ``stream`` its current stream, then
    :func:`check` the result.  CUDA refuses a launch into a stream of
    another device than the current one, and ``cudaFuncSetAttribute``
    acts on the current device only, so a kernel on a shard's card
    (``resources.distributed="data"``) needs that card current."""
    with torch.cuda.device(device):
        check(fn(*args, stream(device)), what)


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a non-zero ``cudaError_t``."""
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
