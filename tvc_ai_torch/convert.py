"""Carry weights, env state and env parameters across from the JAX package.

The inputs are plain host data: nested dicts (or attribute objects) whose
leaves are numpy arrays or anything ``numpy.asarray`` takes. Nothing here
imports JAX or flax; a caller holding JAX pytrees maps them to numpy first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from tvc_ai_torch.env.types import (
    DomainParams,
    EnvParams,
    EnvState,
    RandomizationConfig,
    RewardConfig,
    SuccessConfig,
    TerminationConfig,
)
from tvc_ai_torch.physics.types import RigidBodyState, RocketParams
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device


def _get(obj: Any, name: str) -> Any:
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def actor_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``GaussianActor`` state dict from flax actor params.

    Accepts the variables dict (``{"params": {...}}``) or its inner dict. A
    flax ``Dense`` kernel is (in, out); ``nn.Linear.weight`` is (out, in).
    """
    if "params" in params:
        params = params["params"]
    state = {}
    for layer, leaves in params.items():
        kernel = np.asarray(leaves["kernel"], dtype=np.float32)
        state[f"{layer}.weight"] = torch.from_numpy(np.ascontiguousarray(kernel.T))
        state[f"{layer}.bias"] = torch.tensor(np.asarray(leaves["bias"], dtype=np.float32))
    return state


def _tensor(x: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def env_state_from_numpy(state: Any, device: str | torch.device = DEFAULT_DEVICE) -> EnvState:
    """``EnvState`` from a batched JAX ``EnvState`` mapped to numpy.

    The JAX state's ``key`` and ``prev_imu`` fields have no counterpart here
    and are dropped.
    """
    dev = resolve_device(device)
    body, dr = _get(state, "body"), _get(state, "dr")
    fields = {}
    for f in dataclasses.fields(EnvState):
        if f.name == "body":
            fields["body"] = RigidBodyState(
                **{g.name: _tensor(_get(body, g.name), dev)
                   for g in dataclasses.fields(RigidBodyState)}
            )
        elif f.name == "dr":
            fields["dr"] = DomainParams(
                **{g.name: _tensor(_get(dr, g.name), dev)
                   for g in dataclasses.fields(DomainParams)}
            )
        else:
            fields[f.name] = _tensor(_get(state, f.name), dev)
    return EnvState(**fields)


def _scalar(x: Any, like: Any) -> Any:
    if isinstance(like, bool):
        return bool(np.asarray(x))
    if isinstance(like, int):
        return int(np.asarray(x))
    if isinstance(like, tuple):
        return tuple(float(v) for v in np.asarray(x, dtype=np.float32).reshape(-1))
    return float(np.asarray(x))


def _config(cls: type, src: Any) -> Any:
    default = cls()
    return cls(**{
        f.name: _scalar(_get(src, f.name), getattr(default, f.name))
        for f in dataclasses.fields(cls)
    })


def env_params_from_numpy(params: Any) -> EnvParams:
    """``EnvParams`` from a JAX ``EnvParams`` (leaves as arrays or scalars)."""
    subs = {
        "rocket": RocketParams,
        "randomization": RandomizationConfig,
        "success": SuccessConfig,
        "reward": RewardConfig,
        "termination": TerminationConfig,
    }
    default = EnvParams()
    fields = {}
    for f in dataclasses.fields(EnvParams):
        src = _get(params, f.name)
        if f.name in subs:
            fields[f.name] = _config(subs[f.name], src)
        else:
            fields[f.name] = _scalar(src, getattr(default, f.name))
    return EnvParams(**fields)
