"""The plain reference the benchmark judges the program against.

Plain PyTorch, float32 (or, for the control, one precision lower), written
from the port's plain code and frozen here: it imports nothing of the port
and nothing of the JAX package, and takes nothing the program made. Its
inputs are the configuration file, the draws and the weights the benchmark
makes from the seed, and a state: its own reset's, or the program's at the
start of the chunk it follows.
"""

from __future__ import annotations

import torch

from portbench.reference import env


def chunk(p, action, state: dict, obs: torch.Tensor, steps):
    """Run the steps whose draws ``steps`` holds from ``state`` and ``obs``:
    the action ``action(p, obs, d)`` of the step's draws ``d``, then the env
    step with its autoreset. Returns (state, obs, rewards, terminated,
    truncated), the last three (steps, n)."""
    rewards, terminated, truncated = [], [], []
    for d in steps:
        state, out, obs = env.step_autoreset(
            p, state, action(p, obs, d), _cast(d.get("n_imu"), p.dtype), d.get("u_drop"),
            {k: _cast(v, p.dtype) for k, v in d["reset"].items()})
        rewards.append(out["reward"])
        terminated.append(out["terminated"])
        truncated.append(out["truncated"])
    return state, obs, torch.stack(rewards), torch.stack(terminated), torch.stack(truncated)


def _cast(x, dtype):
    return None if x is None else x.to(dtype)
