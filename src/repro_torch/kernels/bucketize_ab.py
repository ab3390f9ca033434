"""Times the bucketize kernel against another version of its source, in one
process on one card: the A/B comparison of a kernel change.

For each of ``chip_smoke.py``'s bucketize cases, both versions must equal the
plain version exactly; then the profiler's device ms per call of each, taken
in turns (other, this, this, other) over the same inputs, cycled through
copies larger than L2. One JSON line per case, the card's ``nvidia-smi``
name and power limit first. Run from the repository root on the machine with
the card, with the other version unpacked somewhere ``.gitignore`` lists::

    mkdir -p build/parent && git archive <commit> src/repro_torch/csrc/bucketize.cu \\
        | tar -x -C build/parent
    PYTHONPATH=src python -m repro_torch.kernels.bucketize_ab \\
        build/parent/src/repro_torch/csrc/bucketize.cu

The other source must export the same C entry point,
``bucketize(x, bounds, n_bounds, idx, n, stream)``.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import torch

from repro_torch.kernels import build
from repro_torch.kernels.bucketize import bucketize_call, bucketize_plain

ROOT = pathlib.Path(__file__).resolve().parents[3]


def load_other(src: pathlib.Path):
    """Build ``src`` with the kernels' flags and bind its entry point."""
    out = build.build_dir() / "bucketize-other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build._FLAGS, "-I", str(build._CSRC), "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).bucketize
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    return fn


def other_call(fn, x: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """The other kernel on the wrapper's output layout (idx at x's offset
    modulo 128 bytes)."""
    off = x.data_ptr() % 128 // 4
    idx = torch.empty(x.numel() + off, dtype=torch.int32, device=x.device)[off:].view(x.shape)
    build.check(fn(x.data_ptr(), bounds.data_ptr(), bounds.numel(), idx.data_ptr(), x.numel(),
                   torch.cuda.current_stream().cuda_stream), "bucketize (other)")
    return idx


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(cs.smi(), flush=True)
    build.build_all(["bucketize"])
    other = load_other(pathlib.Path(argv[0]))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for m, k, nb, tag, *offset in cs.BUCKETIZE_CASES:
        bounds = cs.bucketize_bounds(nb, dev)
        sets = [cs.bucketize_inputs(gen, m, k, bounds, *offset)
                for _ in range(cs.copies_for(m * k * 8))]
        want = bucketize_plain(sets[0], bounds)
        exact = dict(this=torch.equal(bucketize_call(sets[0], bounds), want),
                     other=torch.equal(other_call(other, sets[0], bounds), want))
        fns = dict(this=[lambda t=t: bucketize_call(t, bounds) for t in sets],
                   other=[lambda t=t: other_call(other, t, bounds) for t in sets])
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            times[side].append(cs.device_ms(fns[side], 100))
        ok &= all(exact.values())
        print(json.dumps(dict(case=tag, M=m, K=k, n_bounds=nb, exact=exact,
                              this_device_ms=times["this"], other_device_ms=times["other"])),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
