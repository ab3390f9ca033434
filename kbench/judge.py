"""How ``correct`` is decided: the served tokens and the last step's logits
against the plain reference (``reference.py``), each number the cell's
file gives a limit for against that limit.

The reference computes in float32 with TF32 off and rounds values to the
configuration's dtype (``torch_dtype``) where the program stores them:
the precision the configuration states. Its numbers:

* over a sample of finished requests (drawn from the seed, the one with the
  longest context always in it), teacher-forced on each prompt and its
  served tokens: ``served_gap_max``, the widest gap by which a served
  token's reference logit lies below the reference's best at its position,
  and ``served_gap_mean``, the mean gap over the served tokens. Greedy
  decoding serves the program's own argmax, so a sound program reads only
  the gaps its rounding opens between near-ties;
* over every cell of the window's last packed step
  (``Scheduler.last_logits``: decode rows and prefill chunks), the relative
  L2 distance of the program's logits from the reference's at the same
  position: ``step_err_max`` (the largest) and ``step_err2_mean`` (the mean
  of its square over the cells).

The control (``control_readings``) is the reference itself computed in
float8 (``reference.fp8_rows`` on every stored activation,
``fp8_tensor`` on the float weights), read the same way: the gap of the
token it puts first, and the distance of its logits.
"""

from __future__ import annotations

import dataclasses

import torch

from kbench import reference

__all__ = ["Case", "readings", "control_readings", "verdict"]


@dataclasses.dataclass
class Case:
    """One sequence given to the reference: its tokens, the positions whose
    logits are compared, and what the program gave there: the served
    tokens (``served``, one per position) or its logits (``logits``)."""

    tokens: list[int]
    positions: list[int]
    served: list[int] | None = None
    logits: torch.Tensor | None = None


def stored(cfg: dict):
    """Rounding to the configuration's dtype (the identity for float32)."""
    dt = getattr(torch, cfg["torch_dtype"])
    return reference.identity if dt == torch.float32 else (lambda x: x.to(dt).float())


def _reference(tree, cfg, quant, cases, device, rnd=None, wrnd=None) -> list[torch.Tensor]:
    rnd = rnd or stored(cfg)
    wrnd = wrnd or stored(cfg)
    seqs = [torch.tensor(c.tokens, dtype=torch.long, device=device) for c in cases]
    want = [torch.tensor(c.positions, dtype=torch.long, device=device) for c in cases]
    return reference.forward(tree, cfg, quant, seqs, want, rnd=rnd, wrnd=wrnd)


def _gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return ref.max(dim=-1).values - ref.gather(-1, tokens[:, None])[:, 0]


def _errs(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return (torch.linalg.vector_norm(got - ref, dim=-1)
            / torch.linalg.vector_norm(ref, dim=-1).clamp(min=1e-30))


def _numbers(gaps: list[torch.Tensor], errs: list[torch.Tensor]) -> dict:
    out = {}
    if gaps:
        g = torch.cat(gaps)
        out.update(served_gap_max=float(g.max()), served_gap_mean=float(g.mean()))
    if errs:
        e = torch.cat(errs)
        out.update(step_err_max=float(e.max()), step_err2_mean=float((e * e).mean()))
    return out


def readings(tree, cfg, quant, cases: list[Case], device) -> tuple[dict, list[torch.Tensor]]:
    """The program's numbers and the reference's logits per case."""
    ref = _reference(tree, cfg, quant, cases, device)
    gaps = [_gaps(r, torch.tensor(c.served, device=device)) for r, c in zip(ref, cases)
            if c.served is not None]
    errs = [_errs(c.logits.to(device).float(), r) for r, c in zip(ref, cases)
            if c.logits is not None]
    return _numbers(gaps, errs), ref


def control_readings(tree, cfg, quant, cases: list[Case], ref: list[torch.Tensor],
                     device) -> dict:
    """The control's numbers at the same positions."""
    ctl = _reference(tree, cfg, quant, cases, device, rnd=reference.fp8_rows,
                     wrnd=reference.fp8_tensor)
    gaps = [_gaps(r, c.argmax(dim=-1)) for r, c, case in zip(ref, ctl, cases)
            if case.served is not None]
    errs = [_errs(c, r) for r, c, case in zip(ref, ctl, cases) if case.logits is not None]
    return _numbers(gaps, errs)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every limit needs its number,
    and each number has to stay at or under its limit."""
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
