"""Tanh-squashed Gaussian policy head.

Counterpart of ``tvc_ai_tpu/models/distributions.py``: reparameterized
sampling, the log-prob of a given pre-tanh action (PPO's ratio) and the
change-of-variables log-prob in the stable softplus form
log(1 - tanh²u) = 2·(log 2 - u - softplus(-2u)); log_std clamped to
[-20, 2]. The standard-normal noise is explicit (``noise``), drawn from
``generator`` when not given.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

LOG_STD_MIN = -20.0
LOG_STD_MAX = 2.0


def clamp_log_std(log_std: torch.Tensor) -> torch.Tensor:
    return torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)


def sample_and_log_prob(
    mean: torch.Tensor,
    log_std: torch.Tensor,
    noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reparameterized tanh-Gaussian sample and its log-prob summed over dims."""
    log_std = clamp_log_std(log_std)
    if noise is None:
        noise = torch.randn(mean.shape, dtype=mean.dtype, device=mean.device,
                            generator=generator)
    pre_tanh = mean + torch.exp(log_std) * noise
    action = torch.tanh(pre_tanh)
    gauss_logp = -0.5 * (noise**2 + 2.0 * log_std + math.log(2.0 * math.pi))
    correction = 2.0 * (math.log(2.0) - pre_tanh - F.softplus(-2.0 * pre_tanh))
    return action, (gauss_logp - correction).sum(dim=-1)


def log_prob(mean: torch.Tensor, log_std: torch.Tensor, pre_tanh: torch.Tensor) -> torch.Tensor:
    """Log-prob of a given pre-tanh action under the tanh-Gaussian, summed over dims."""
    log_std = clamp_log_std(log_std)
    z = (pre_tanh - mean) / torch.exp(log_std)
    gauss_logp = -0.5 * (z**2 + 2.0 * log_std + math.log(2.0 * math.pi))
    correction = 2.0 * (math.log(2.0) - pre_tanh - F.softplus(-2.0 * pre_tanh))
    return (gauss_logp - correction).sum(dim=-1)


def deterministic_action(mean: torch.Tensor) -> torch.Tensor:
    return torch.tanh(mean)
