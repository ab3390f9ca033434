"""Fault-tolerant checkpointing (port of ``repro/checkpoint/checkpointer.py``):
atomic, integrity-checked, resumable.

Layout per step, JAX's but for the shard format::

    <dir>/step_<N:08d>/shard_<host>.json   # {leaf key: {dtype, shape, offset, nbytes}}
    <dir>/step_<N:08d>/shard_<host>.raw    # the leaves' raw bytes, concatenated
    <dir>/step_<N:08d>/MANIFEST.json       # step, host count, per-leaf sha256(raw)[:16]
    <dir>/step_<N:08d>/COMMIT              # written LAST -> crash-atomic

JAX's shards are msgpack (zstd-compressed where it is installed); the
port's are raw bytes with a JSON index, so they need neither package.
Leaves are named by JAX's ``keystr`` of their path (``['state']['params']
['blocks']['attn']['wq']['w']``) and dict keys are walked in sorted order,
as ``jax.tree_util`` walks them, so a state carried across from the JAX
package has the same manifest digests on both sides. A tree is nested
dicts, lists and tuples over tensors, numpy arrays and Python scalars;
bfloat16 tensors are stored as their bits under the dtype name
``bfloat16``, as JAX names it.

A sharded leaf (a DTensor) is saved unsharded and logical: every rank
gathers it (a collective, so every rank calls ``save``), and under an
initialised process group only rank 0 writes. Any mesh can then load the
checkpoint, and its digests equal a single-process save's.

Restore is template-based: leaves are matched by key. A step without
COMMIT (a crash mid-write) is ignored by ``restore_latest``; with the data
pipeline's state in the checkpoint, a restart resumes from the last durable
step with no data replayed or skipped. Each process writes only its own
shard; process 0 writes the manifest.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import re
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

__all__ = ["save_checkpoint", "load_checkpoint", "CheckpointManager"]

_TORCH_DTYPES = {"bfloat16": torch.bfloat16}


def _paths(tree, prefix: str = ""):
    """(JAX keystr, leaf) pairs in ``jax.tree_util``'s order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _leaf_raw(leaf) -> tuple[str, list[int], bytes]:
    """(dtype name, shape, raw bytes) of one leaf, gathered if sharded and
    copied to the host."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", list(t.shape), t.view(torch.uint16).numpy().tobytes()
        leaf = t.numpy()
    a = np.asarray(leaf)
    return str(a.dtype), list(a.shape), a.tobytes()


def _from_raw(dtype: str, shape: list[int], raw: bytes) -> torch.Tensor:
    if dtype in _TORCH_DTYPES:
        t = torch.frombuffer(bytearray(raw), dtype=torch.uint16).view(_TORCH_DTYPES[dtype])
    else:
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype)).copy())
    return t.reshape(shape)


def _digest(raw: bytes) -> str:
    return hashlib.sha256(raw).hexdigest()[:16]


def _flatten(tree) -> dict[str, tuple[str, list[int], bytes]]:
    return {k: _leaf_raw(v) for k, v in _paths(tree)}


def _write(directory: str, step: int, flat: dict, process_index: int,
           process_count: int) -> pathlib.Path:
    d = pathlib.Path(directory) / f"step_{step:08d}"
    tmp = d.parent / f".tmp_step_{step:08d}_{process_index}"
    tmp.mkdir(parents=True, exist_ok=True)
    index, offset = {}, 0
    with open(tmp / f"shard_{process_index}.raw", "wb") as f:
        for k, (dtype, shape, raw) in flat.items():
            f.write(raw)
            index[k] = {"dtype": dtype, "shape": shape, "offset": offset, "nbytes": len(raw)}
            offset += len(raw)
    (tmp / f"shard_{process_index}.json").write_text(json.dumps(index))
    if process_index == 0:
        manifest = {"step": step, "process_count": process_count,
                    "leaves": {k: _digest(raw) for k, (_, _, raw) in flat.items()}}
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
    d.mkdir(parents=True, exist_ok=True)
    for f in tmp.iterdir():
        f.replace(d / f.name)
    tmp.rmdir()
    (d / "COMMIT").write_text("ok")  # commit marker LAST
    return d


def save_checkpoint(directory: str, step: int, tree, process_index: int = 0,
                    process_count: int = 1) -> pathlib.Path:
    return _write(directory, step, _flatten(tree), process_index, process_count)


def load_checkpoint(directory: str, step: int, template, verify: bool = True):
    """The tree of ``template`` with every leaf read from step ``step``, as a
    CPU tensor (0-d for scalars)."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    if not (d / "COMMIT").exists():
        raise FileNotFoundError(f"checkpoint {d} has no COMMIT marker (incomplete)")
    payload: dict[str, tuple[str, list[int], bytes]] = {}
    for index_f in sorted(d.glob("shard_*.json")):
        raw = index_f.with_suffix(".raw").read_bytes()
        for k, e in json.loads(index_f.read_text()).items():
            payload[k] = (e["dtype"], e["shape"], raw[e["offset"]: e["offset"] + e["nbytes"]])
    if verify and (d / "MANIFEST.json").exists():
        manifest = json.loads((d / "MANIFEST.json").read_text())
        for k, h in manifest["leaves"].items():
            if k not in payload or _digest(payload[k][2]) != h:
                raise IOError(f"checkpoint corruption detected at leaf {k}")

    def rebuild(tmpl, prefix: str = ""):
        if isinstance(tmpl, dict):
            return {k: rebuild(v, f"{prefix}[{k!r}]") for k, v in tmpl.items()}
        if isinstance(tmpl, (list, tuple)):
            return type(tmpl)(rebuild(v, f"{prefix}[{i}]") for i, v in enumerate(tmpl))
        if prefix not in payload:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        return _from_raw(*payload[prefix])

    return rebuild(template)


class CheckpointManager:
    """Cadenced saves, retention, latest-valid discovery, optional async."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    def steps(self) -> list[int]:
        out = []
        for d in self.dir.glob("step_*"):
            if (d / "COMMIT").exists():
                m = re.fullmatch(r"step_(\d+)", d.name)
                if m:
                    out.append(int(m.group(1)))
        return sorted(out)

    def save(self, tree, step: int):
        self.wait()  # one async save in flight at a time
        flat = _flatten(tree)  # a host snapshot before the async write
        if dist.is_initialized() and dist.get_rank() != 0:
            return  # the gathered state is the same on every rank: rank 0 writes it

        def _do():
            _write(str(self.dir), step, flat, 0, 1)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore(self, step: int, template):
        return load_checkpoint(str(self.dir), step, template)

    def restore_latest(self, template):
        steps = self.steps()
        return self.restore(steps[-1], template) if steps else None

    def _gc(self):
        steps = self.steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
