"""The learners' optimizers, written out: global-norm clipping, Adam, LR
schedules, the Polyak target update.

Counterpart of the optax chain ``tvc_ai_tpu/agents/sac.py::_optim`` builds,
``chain(clip_by_global_norm(max_norm), adam(schedule))`` (TD3's and PPO's
``_optim`` are the same chain at a constant lr), and of the plain
``adam(lr)`` the temperature uses. Each step follows optax's order of
operations over a list of tensors:

- ``clip_by_global_norm``: g unchanged when ‖g‖ < max_norm, else
  g · max_norm / ‖g‖ (not ``torch.nn.utils.clip_grad_norm_``, which scales
  by max_norm / (‖g‖ + 1e-6) and also when ‖g‖ equals max_norm);
- Adam with b1 0.9, b2 0.999, eps 1e-8, eps_root 0:
  mu ← (1 − b1)·g + b1·mu, nu ← (1 − b2)·g² + b2·nu, t ← count + 1,
  update = (mu / (1 − b1ᵗ)) / (sqrt(nu / (1 − b2ᵗ)) + eps), and
  p ← p − lr(count) · update, the learning rate taken at the count before
  the increment (as ``optax.scale_by_schedule`` does).

``AdamState`` holds (mu, nu, count), so ``convert`` maps optax's
``ScaleByAdamState`` one to one. ``count`` is a host int: it depends only on
how many steps ran, so the schedules and bias corrections need no device
synchronisation. The scalars they give are computed in float32, as the
reference computes them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
SCHEDULES = ("constant", "linear", "exponential", "cosine", "warmup_cosine")


@dataclasses.dataclass
class AdamState:
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    count: int = 0


def adam_init(params: Sequence[torch.Tensor]) -> AdamState:
    return AdamState(
        mu=[torch.zeros_like(p) for p in params],
        nu=[torch.zeros_like(p) for p in params],
    )


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element of every tensor: the norm
    of the per-tensor norms, in a few launches whatever the tensor count."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """optax ``clip_by_global_norm``: returns new tensors; the norm test runs
    on the device (no synchronisation)."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    return list(torch._foreach_mul(grads, scale))


def adam_step(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    state: AdamState,
    lr: float,
) -> None:
    """One Adam step in place on ``params`` and ``state`` (call under
    ``torch.no_grad``)."""
    params, grads = list(params), list(grads)
    torch._foreach_mul_(state.mu, B1)
    torch._foreach_add_(state.mu, grads, alpha=1.0 - B1)
    torch._foreach_mul_(state.nu, B2)
    torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - B2)
    state.count += 1
    t = np.float32(state.count)
    bc1 = float(np.float32(1.0) - np.float32(B1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(B2) ** t)
    denom = torch._foreach_div(state.nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    step = torch._foreach_div(state.mu, bc1)
    torch._foreach_div_(step, denom)
    torch._foreach_mul_(step, -float(np.float32(lr)))
    torch._foreach_add_(params, step)


def polyak(targets: Sequence[torch.Tensor], params: Sequence[torch.Tensor], tau: float) -> None:
    """targets ← targets · (1 − τ) + params · τ, in place (call under
    ``torch.no_grad``)."""
    targets = list(targets)
    torch._foreach_mul_(targets, 1.0 - tau)
    torch._foreach_add_(targets, list(params), alpha=tau)


def make_schedule(
    name: str,
    lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    initial_lr_factor: float = 0.1,
) -> Callable[[int], float]:
    """The learning rate at an optimizer count, as ``sac._optim`` builds it:
    ``constant``; ``linear`` lr → 0 over ``total_steps``; ``exponential``
    halving every ``max(total_steps // 10, 1)`` steps (staircase);
    ``cosine`` lr → 0 over ``total_steps``; ``warmup_cosine`` linear from
    lr·initial_lr_factor to lr over ``warmup_steps``, then cosine to 0 over
    ``max(total_steps, warmup_steps + 1) − warmup_steps``."""
    if name == "constant":
        return lambda count: lr

    if name == "linear":
        return linear(lr, 0.0, total_steps)
    if name == "exponential":
        return staircase_decay(lr, max(total_steps // 10, 1), 0.5)
    if name == "cosine":
        return cosine_decay(lr, total_steps)
    if name == "warmup_cosine":
        warm = linear(lr * initial_lr_factor, lr, warmup_steps)
        decay = cosine_decay(lr, max(total_steps, warmup_steps + 1) - warmup_steps)
        return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)
    raise ValueError(f"unknown lr_schedule {name!r}")


def linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule(init, end, steps)``: init → end over ``steps``
    counts, then flat (float32); ``init`` throughout when ``steps`` ≤ 0."""
    if steps <= 0:
        return lambda count: init
    f32 = np.float32

    def fn(count: int) -> float:
        frac = f32(1.0) - f32(min(max(count, 0), steps)) / f32(steps)
        return float(f32(init - end) * frac + f32(end))
    return fn


def staircase_decay(lr: float, period: int, rate: float) -> Callable[[int], float]:
    """optax ``exponential_decay(lr, period, rate, staircase=True)``: lr ·
    rate^⌊count / period⌋ (float32), lr at counts ≤ 0."""
    f32 = np.float32

    def fn(count: int) -> float:
        if count <= 0:
            return lr
        p = np.floor(f32(count) / f32(period))
        return float(f32(lr) * f32(rate) ** p)
    return fn


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax ``cosine_decay_schedule(lr, decay_steps, alpha)``: lr → lr·alpha
    along a half cosine over ``decay_steps`` counts, then flat (float32)."""
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay steps, got {decay_steps}")
    f32 = np.float32

    def fn(count: int) -> float:
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * c / f32(decay_steps)))
        return float(f32(lr) * ((f32(1.0) - f32(alpha)) * cosine + f32(alpha)))
    return fn
