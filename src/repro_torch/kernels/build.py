"""Builds the hand-written CUDA kernels and binds them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``<repo>/build/kernels/<name>-<hash>.so``
(the hash covers the source and the flags, so an edited source rebuilds).
Building happens at first use, never at import: a machine without ``nvcc``
can import every module and run the plain versions on CPU tensors.
``build_all`` starts one ``nvcc`` per source at once and waits for all.

``entry`` loads a library and binds its C entry point once: ``argtypes``
and ``restype`` are set on first use and the bound function is cached.

Launch accounting lives here too: ``LAUNCHES[name]`` counts the times a
wrapper launched its kernel, ``PLAIN_ON_CUDA[name]`` the times a plain
version ran on a CUDA tensor (a run that should have gone through the
kernel, or a deliberate comparison). So do the launch helpers the split
kernels share: ``SMS`` and the zeroed ``tickets`` of a stream.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from collections import Counter
from collections.abc import Callable

import torch

__all__ = ["KERNELS", "LAUNCHES", "PLAIN_ON_CUDA", "SMS", "reset_counts", "build_all",
           "entry", "build_dir", "check", "tickets"]

KERNELS = ("fused_lut_gemm", "topk_outlier", "paged_attn_int4", "paged_attn_bf16",
           "streaming_quantize_outlier", "lut_gemm", "bucketize")
LAUNCHES: Counter = Counter()
PLAIN_ON_CUDA: Counter = Counter()

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo"]
_ENTRIES: dict[str, Callable[..., int]] = {}
# argument codes of ``entry``: pointer (and stream), int, float, long long
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float,
           "q": ctypes.c_longlong}
SMS = 132  # streaming multiprocessors of an H100 SXM
_TICKETS: dict[tuple[int, int], torch.Tensor] = {}
BUILD_LOG: dict[str, str] = {}


def reset_counts() -> None:
    LAUNCHES.clear()
    PLAIN_ON_CUDA.clear()


def build_dir() -> pathlib.Path:
    """``build/kernels`` at the checkout's root (listed in ``.gitignore``)."""
    return _CSRC.parents[2] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are built on the machine with the card")


def _target(name: str) -> tuple[pathlib.Path, pathlib.Path]:
    src = _CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(_FLAGS).encode())
    for inc in sorted(_CSRC.glob("*.cuh")):
        h.update(inc.read_bytes())
    return src, build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=KERNELS) -> float:
    """Compile every missing library in parallel; returns the seconds spent."""
    t0 = time.perf_counter()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, so = _target(name)
        if so.exists():
            continue
        tmp = so.with_name(so.name + f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, so)
    errors = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            tmp.replace(so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def entry(name: str, args: str) -> Callable[..., int]:
    """The C entry point ``name`` of kernel library ``name`` (built first if
    missing), returning ``int``, with one argument per character of ``args``
    (``p`` pointer or stream, ``i`` int, ``f`` float, ``q`` long long). Bound
    on the first call and cached: later calls cost a dictionary lookup."""
    fn = _ENTRIES.get(name)
    if fn is None:
        _, so = _target(name)
        if not so.exists():
            build_all([name])
        fn = getattr(ctypes.CDLL(str(so)), name)  # the function keeps its library loaded
        fn.restype = ctypes.c_int
        fn.argtypes = [_CTYPES[c] for c in args]
        _ENTRIES[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 counters for one stream: the split kernels
    count their finished blocks here, and the last block resets its counter.
    Kernels on one stream run in turn, so they share the buffer."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t
