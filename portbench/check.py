"""The comparison that decides ``correct`` in the env entries.

The program's rows are held against the reference's, row by row (each env
over a chunk is an answer of its own: no env reads another's state):

- ``departed_pct``: the share of the checked envs, in percent, whose
  discrete outcome differs anywhere in the chunk: a step's termination or
  truncation, or the final step count, phase, success flag and count, the
  window length or the previous-action flag. A flag sits on a threshold of a
  float (a crash altitude, a tilt limit), so rounding alone flips one now and
  then;
- over the envs that did not depart, each env's widest gap between the
  program's and the reference's floats, |p - r| / (1 + |r|), over every
  step's reward, the final observation and every float of the final state:
  ``gap_p99`` and ``gap_p999``, its 99th and 99.9th percentiles, which read
  the bulk, and ``gap_max``, the widest of all, which holds every env. The
  widest swings from seed to seed: a reward term that steps at a tilt, rate,
  altitude or effort threshold (by 10 reward units at most) jumps when
  rounding carries the value across, with no discrete flag to show it;
- ``start_gap``: the same gap over the set-up's first reset and observation
  of the checked envs, with any discrete difference read as infinite.

A non-finite program value reads as an infinite gap.
"""

from __future__ import annotations

import math

import torch

NUMBERS = ("departed_pct", "gap_p99", "gap_p999", "gap_max", "start_gap")
DISCRETE = ("step_count", "phase", "mission_success", "success_count", "has_prev_action",
            "reward_window_len")


def _gap(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-row widest |p - r| / (1 + |r|) in float64; inf where p is not finite."""
    p, r = p.double().reshape(p.shape[0], -1), r.double().reshape(r.shape[0], -1)
    g = (p - r).abs() / (1.0 + r.abs())
    g = torch.where(torch.isfinite(p), g, torch.full_like(g, math.inf))
    return torch.nan_to_num(g, nan=math.inf).amax(dim=1)


def _discrete_off(prog: dict, ref: dict) -> torch.Tensor:
    """(rows,) True where any discrete outcome differs."""
    off = (prog["terminated"] != ref["terminated"]).any(0)
    off |= (prog["truncated"] != ref["truncated"]).any(0)
    for k in DISCRETE:
        off |= (prog["state"][k] != ref["state"][k]).reshape(off.shape[0], -1).any(1)
    return off


def chunk_numbers(prog: dict, ref: dict) -> tuple[dict[str, float], str]:
    """``departed_pct``, ``gap_p99``, ``gap_p999`` and ``gap_max`` of the
    checked envs, and the field that holds ``gap_max``; ``prog`` and ``ref``
    hold the envs' ``state`` (a flat dict),
    ``obs`` and the (steps, rows) ``reward``, ``terminated`` and
    ``truncated``."""
    off = _discrete_off(prog, ref)
    rows = off.shape[0]
    fields = {"reward": _gap(prog["reward"].T, ref["reward"].T),
              "obs": _gap(prog["obs"], ref["obs"])}
    fields.update({k: _gap(v, ref["state"][k]) for k, v in prog["state"].items()
                   if v.is_floating_point()})
    per_field = torch.stack(list(fields.values()))[:, ~off]
    kept = per_field.amax(0) if per_field.shape[1] else torch.full((1,), math.inf,
                                                                    dtype=torch.float64)
    q = torch.nan_to_num(kept, posinf=1e300)
    where = list(fields)[int(per_field.amax(1).argmax())] if per_field.shape[1] else "-"
    return {"departed_pct": 100.0 * float(off.sum()) / rows,
            "gap_p99": float(torch.quantile(q, 0.99)) if torch.isfinite(kept).all()
            else math.inf,
            "gap_p999": float(torch.quantile(q, 0.999)), "gap_max": float(kept.max())}, where


def start_gap(prog_state: dict, prog_obs, ref_state: dict, ref_obs) -> float:
    for k in DISCRETE:
        if not torch.equal(prog_state[k], ref_state[k]):
            return math.inf
    gaps = [_gap(prog_obs, ref_obs)] + [_gap(v, ref_state[k]) for k, v in prog_state.items()
                                        if v.is_floating_point()]
    return float(torch.stack(gaps).amax())
