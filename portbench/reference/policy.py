"""The plain policy: the SAC actor's forward pass, the tanh-Gaussian sample
and the analytic safety projection.

A frozen copy of the port's plain act path. The actor is given as its
weights, ``[(W, b), ...]`` for the hidden layers then the mean and log-std
heads (``W`` of shape (out, in)). With ``lower`` the products run in TF32,
one precision below the configuration's float32 with TF32 off.
"""

from __future__ import annotations

import contextlib

import torch

from portbench.reference.params import LOG_STD_MIN, LOG_STD_MAX


@contextlib.contextmanager
def _tf32(on: bool):
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.T + b).to(x.dtype)


def actor(weights, obs: torch.Tensor, lower: bool = False):
    """(mean, log_std) of the Gaussian before the tanh."""
    *hidden, (wm, bm), (ws, bs) = weights
    with _tf32(lower):
        x = obs
        for w, b in hidden:
            x = torch.relu(_dense(x, w, b))
        return _dense(x, wm, bm), _dense(x, ws, bs)


def sample(mean: torch.Tensor, log_std: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    return torch.tanh(mean + torch.exp(log_std) * noise)


def safety(obs: torch.Tensor, action: torch.Tensor, c) -> torch.Tensor:
    """Replace the action by a PD stabilizing gimbal on a tilt or rate
    violation and rescale it onto the effort ball, only where a constraint
    (tilt, angular rate, effort) is violated."""
    omega = obs[..., 4:7]
    x, y, z, w = obs[..., 0], obs[..., 1], obs[..., 2], obs[..., 3]
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    tilt = torch.sqrt(pitch ** 2 + yaw ** 2)
    omega_mag = torch.linalg.vector_norm(omega, dim=-1)
    effort = torch.linalg.vector_norm(action, dim=-1)
    mask = ((tilt > c.max_tilt) | (omega_mag > c.max_angular_velocity)
            | (effort > c.max_control_effort))
    stabilize = torch.clamp(torch.stack([-2.0 * pitch - 0.5 * omega[..., 1],
                                         -2.0 * yaw - 0.5 * omega[..., 2]], dim=-1), -1.0, 1.0)
    attitude_bad = (tilt > c.max_tilt) | (omega_mag > c.max_angular_velocity)
    out = torch.where(attitude_bad[..., None], stabilize, action)
    out_effort = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
    out = torch.where(out_effort > c.max_control_effort,
                      out * (c.max_control_effort / torch.clamp(out_effort, min=1e-8)), out)
    safe = torch.clamp(out, -1.0, 1.0)
    return torch.where(mask[..., None], safe, action)


def act(p, weights, obs: torch.Tensor, noise: torch.Tensor, lower: bool = False):
    """The policy's action for ``obs`` with exploration noise ``noise``."""
    mean, log_std = actor(weights, obs, lower)
    action = sample(mean, log_std, noise)
    return safety(obs, action, p.safety) if p.safety is not None else action
