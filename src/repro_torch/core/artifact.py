"""Quantized artifacts in the JAX package's format (``repro/core/artifact.py``).

An artifact directory holds ``manifest.json`` (format version, the model
config, the QuantSpec, per-tensor dtype / shape / sha256 prefix and the tree
structure) and ``tensors.npz`` (every tensor as raw uint8 bytes). The loader
reinterprets the bytes by the manifest's dtype -- bfloat16 through a uint8 ->
``torch.bfloat16`` view, so neither JAX nor ``ml_dtypes`` is needed -- checks
the hashes and rebuilds the port's model. Scan-stacked leaves under
``blocks`` carry a leading layer axis and are split per layer.

``save_quantized`` writes the same format from the port's model, with the
layers stacked again when the config scans them, so the JAX package's
``load_quantized`` reads it. Tensors go first and the manifest last, through
a rename: a directory without a manifest is an interrupted save. The
manifest may carry per-tap calibration statistics (``calib_stats``) for the
quality probes' drift scores; :func:`load_calib_stats` reads them from an
artifact of either package.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.qlinear import QLinearParams
from repro_torch.core.quantize import QuantizedWeight
from repro_torch.core.quantspec import QuantSpec, _cfg_from_json, _cfg_to_json
from repro_torch.device import resolve_device

__all__ = ["QuantizedArtifact", "save_quantized", "load_quantized", "load_tensors",
           "load_calib_stats", "FORMAT_VERSION"]

FORMAT_VERSION = 1

_TORCH_DTYPES = {
    "float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float64": torch.float64, "int32": torch.int32, "int64": torch.int64,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}


class QuantizedArtifact(NamedTuple):
    model: Any  # repro_torch.models.model.Model
    params: Any  # repro_torch.models.transformer.TransformerLM
    spec: QuantSpec


def _manifest(d: pathlib.Path) -> dict:
    mf = d / "manifest.json"
    if not mf.exists():
        raise FileNotFoundError(f"{d} has no manifest.json (not an artifact, "
                                "or an interrupted save)")
    manifest = json.loads(mf.read_text())
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(f"artifact format {manifest['format_version']} != "
                         f"supported {FORMAT_VERSION}")
    return manifest


def load_tensors(directory: str, device="cpu", verify: bool = True) -> dict[str, torch.Tensor]:
    """Every tensor of an artifact by its manifest name, byte-exact."""
    d = pathlib.Path(directory)
    manifest = _manifest(d)
    out = {}
    with np.load(d / "tensors.npz") as z:
        for name, meta in manifest["tensors"].items():
            raw = np.ascontiguousarray(z[name]).view(np.uint8)
            if verify and hashlib.sha256(raw.tobytes()).hexdigest()[:16] != meta["sha256"]:
                raise IOError(f"artifact corruption detected at tensor {name}")
            dt = _TORCH_DTYPES[meta["dtype"]]
            t = torch.from_numpy(raw.copy()).view(dt).reshape(meta["shape"])
            out[name] = t.to(device)
    return out


def _unflatten(node: dict, tensors: dict[str, torch.Tensor]):
    kind = node["kind"]
    if kind == "dict":
        return {k: _unflatten(v, tensors) for k, v in node["items"].items()}
    if kind == "list":
        return [_unflatten(v, tensors) for v in node["items"]]
    if kind == "qlinear":
        f = {k: (None if v is None else tensors[v]) for k, v in node["fields"].items()}
        qw = QuantizedWeight(packed=f["qw.packed"], codebook=f["qw.codebook"],
                             scale=f["qw.scale"], shape=tuple(node["qw_shape"]),
                             nbits=node["qw_nbits"])
        return QLinearParams(qw=qw, act_codebook=f["act_codebook"], bias=f["bias"],
                             thr_lo=f["thr_lo"], thr_hi=f["thr_hi"],
                             cfg=_cfg_from_json(node["cfg"]))
    if kind == "none":
        return None
    return tensors[node["tensor"]]


def _flatten(tree, path: str, tensors: dict[str, torch.Tensor]) -> dict:
    """The manifest's structure node of ``tree``; tensors go into ``tensors``."""
    if isinstance(tree, dict):
        return {"kind": "dict", "items": {k: _flatten(v, f"{path}/{k}" if path else k, tensors)
                                          for k, v in tree.items()}}
    if isinstance(tree, list):
        return {"kind": "list", "items": [_flatten(v, f"{path}/{i}", tensors)
                                          for i, v in enumerate(tree)]}
    if isinstance(tree, QLinearParams):
        qw = tree.qw
        arrays = {"qw.packed": qw.packed, "qw.codebook": qw.codebook, "qw.scale": qw.scale,
                  "act_codebook": tree.act_codebook, "bias": tree.bias,
                  "thr_lo": tree.thr_lo, "thr_hi": tree.thr_hi}
        fields = {}
        for f, v in arrays.items():
            fields[f] = None if v is None else f"{path}.{f}"
            if v is not None:
                tensors[fields[f]] = v
        return {"kind": "qlinear", "cfg": _cfg_to_json(tree.cfg), "qw_shape": list(qw.shape),
                "qw_nbits": qw.nbits, "fields": fields}
    if tree is None:
        return {"kind": "none"}
    tensors[path] = tree
    return {"kind": "array", "tensor": path}


def save_quantized(directory: str, model_cfg: ModelConfig, spec: QuantSpec,
                   qparams, calib_stats: dict | None = None) -> pathlib.Path:
    """Write the port's quantized model (a ``TransformerLM``) as an artifact
    the JAX package's ``load_quantized`` reads; returns the directory.

    ``calib_stats``: optional ``{tap_name: stats}`` for drift detection,
    each ``stats`` either the dict ``core.numerics.activation_stats``
    returns or the raw (tokens, K) calibration activations, summarised
    here. Stored in the manifest, as JAX stores them."""
    from repro_torch.models.model import tree_from_params

    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    (d / "manifest.json").unlink(missing_ok=True)  # a stale manifest must not pair with new tensors
    tensors: dict[str, torch.Tensor] = {}
    structure = _flatten(tree_from_params(qparams), "", tensors)
    byte_arrays = {k: t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy()
                   for k, t in tensors.items()}
    np.savez(d / "tensors.npz", **byte_arrays)
    manifest = {
        "format_version": FORMAT_VERSION,
        "model": dataclasses.asdict(model_cfg),
        "spec": spec.to_json_dict(),
        "structure": structure,
        "tensors": {k: {"dtype": str(t.dtype).removeprefix("torch."), "shape": list(t.shape),
                        "sha256": hashlib.sha256(byte_arrays[k]).hexdigest()[:16]}
                    for k, t in tensors.items()},
    }
    if calib_stats:
        from repro_torch.core import numerics

        manifest["calib_stats"] = {
            tap: dict(st) if isinstance(st, dict) else numerics.activation_stats(st)
            for tap, st in calib_stats.items()}
    tmp = d / ".manifest.json.tmp"
    tmp.write_text(json.dumps(manifest, indent=1))
    tmp.replace(d / "manifest.json")
    return d


def load_calib_stats(directory: str) -> dict | None:
    """Per-tap calibration statistics of an artifact's manifest, or None for
    an artifact saved without them (the scheduler then takes the first
    probed step as the drift baseline)."""
    mf = pathlib.Path(directory) / "manifest.json"
    if not mf.exists():
        raise FileNotFoundError(f"{directory} has no manifest.json")
    return json.loads(mf.read_text()).get("calib_stats")


def load_quantized(directory: str, device=None, verify: bool = True) -> QuantizedArtifact:
    """(model, params, spec) of a saved artifact; no K-Means runs here."""
    from repro_torch.models.model import build, params_from_tree

    dev = resolve_device(device)
    d = pathlib.Path(directory)
    manifest = _manifest(d)
    tensors = load_tensors(directory, dev, verify)
    tree = _unflatten(manifest["structure"], tensors)
    spec = QuantSpec.from_json_dict(manifest["spec"])
    mc = dict(manifest["model"])
    mc["block_pattern"] = tuple(mc.get("block_pattern", ()))
    cfg = ModelConfig(**mc)
    model = build(cfg)
    return QuantizedArtifact(model=model, params=params_from_tree(tree, cfg), spec=spec)
