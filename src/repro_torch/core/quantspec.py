"""Declarative per-layer quantization policy (port of ``repro/core/quantspec.py``).

An ordered list of ``(path glob -> QLinearConfig overrides | "skip")`` rules
resolved against each projection's parameter path; later rules win. Paths
are ``/``-separated, e.g. ``blocks/attn/wq`` (a scan-stacked layer stack
shares one path per projection) or ``blocks/3/mlp/wd`` (unscanned), and a
pattern matches the full path or any trailing sub-path. The JSON form is the
one JAX artifacts store.
"""

from __future__ import annotations

import dataclasses
from fnmatch import fnmatchcase
from typing import Any, Iterable, Mapping, Union

import torch

from repro_torch.core.qlinear import QLinearConfig

__all__ = ["QuantRule", "QuantSpec"]

_CFG_FIELDS = {f.name for f in dataclasses.fields(QLinearConfig)}

RuleLike = Union["QuantRule", tuple]


@dataclasses.dataclass(frozen=True)
class QuantRule:
    """One rule: ``pattern`` glob -> sorted (field, value) overrides, or skip."""

    pattern: str
    overrides: tuple = ()
    skip: bool = False

    def __post_init__(self):
        bad = [k for k, _ in self.overrides if k not in _CFG_FIELDS]
        if bad:
            raise ValueError(
                f"rule {self.pattern!r}: unknown QLinearConfig field(s) {bad}; "
                f"valid: {sorted(_CFG_FIELDS)}")
        if self.skip and self.overrides:
            raise ValueError(f"rule {self.pattern!r}: 'skip' takes no overrides")

    def matches(self, path: str) -> bool:
        return fnmatchcase(path, self.pattern) or fnmatchcase(path, "*/" + self.pattern)


def _as_rule(r: RuleLike) -> QuantRule:
    if isinstance(r, QuantRule):
        return r
    pattern, body = r
    if isinstance(body, str):
        if body != "skip":
            raise ValueError(f"rule {pattern!r}: string body must be 'skip', got {body!r}")
        return QuantRule(pattern=pattern, skip=True)
    if isinstance(body, Mapping):
        return QuantRule(pattern=pattern, overrides=tuple(sorted(body.items())))
    raise TypeError(f"rule {pattern!r}: body must be 'skip' or a dict of overrides")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Whole-model policy. ``kv_bits``: None = fp KV cache, 4 = K-Means int4."""

    base: QLinearConfig = QLinearConfig()
    rules: tuple = ()
    kv_bits: int | None = None
    kv_dtype: str = "bfloat16"

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(_as_rule(r) for r in self.rules))
        if self.kv_bits not in (None, 4):
            raise ValueError(f"kv_bits must be None or 4 (K-Means int4), got {self.kv_bits}")

    def resolve(self, path: str) -> QLinearConfig | None:
        """Resolved config for the projection at ``path`` (None = keep dense)."""
        cfg, skip = self.base, False
        for rule in self.rules:
            if not rule.matches(path):
                continue
            if rule.skip:
                skip = True
            else:
                skip = False
                cfg = dataclasses.replace(cfg, **dict(rule.overrides))
        return None if skip else cfg.validate()

    def to_json_dict(self) -> dict:
        return {
            "base": _cfg_to_json(self.base),
            "rules": [{"pattern": r.pattern, "skip": r.skip,
                       "overrides": _vals_to_json(r.overrides)} for r in self.rules],
            "kv_bits": self.kv_bits,
            "kv_dtype": self.kv_dtype,
        }

    @classmethod
    def from_json_dict(cls, d: dict) -> "QuantSpec":
        rules = tuple(
            QuantRule(pattern=r["pattern"], skip=r.get("skip", False),
                      overrides=tuple(sorted(_vals_from_json(r.get("overrides", {})).items())))
            for r in d.get("rules", []))
        return cls(base=_cfg_from_json(d["base"]), rules=rules,
                   kv_bits=d.get("kv_bits"), kv_dtype=d.get("kv_dtype", "bfloat16"))


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _vals_to_json(items: Iterable[tuple[str, Any]] | Mapping) -> dict:
    items = items.items() if isinstance(items, Mapping) else items
    return {k: (_dtype_name(v) if k == "compute_dtype" else v) for k, v in items}


def _vals_from_json(d: Mapping) -> dict:
    return {k: (getattr(torch, v) if k == "compute_dtype" else v) for k, v in d.items()}


def _cfg_to_json(cfg: QLinearConfig) -> dict:
    return _vals_to_json({f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})


def _cfg_from_json(d: Mapping) -> QLinearConfig:
    return QLinearConfig(**_vals_from_json(d))
