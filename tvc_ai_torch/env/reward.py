"""Multi-objective reward with anti-hacking terms, branch-free and batched.

Counterpart of ``tvc_ai_tpu/env/reward.py::compute_reward``. The variance
penalty uses the reference's masked population variance over the rolling
window (mask on the first ``len`` slots, mean over the whole window sum),
not ``torch.var``. The two optional terms that need the env's state, the
survival-normalized success payout and equilibrium-relative tilt shaping,
live in ``rocket_env._post_physics``, as in the reference.
"""

from __future__ import annotations

import torch

from tvc_ai_torch.env.types import PHASE_LANDING, RewardConfig


def compute_reward(
    cfg: RewardConfig,
    *,
    altitude: torch.Tensor,
    tilt: torch.Tensor,
    angular_velocity_mag: torch.Tensor,
    fuel: torch.Tensor,
    crashed: torch.Tensor,
    mission_successful: torch.Tensor,  # pre-update flag
    phase: torch.Tensor,               # pre-update phase
    action: torch.Tensor,              # (N, 2), already clipped
    prev_action: torch.Tensor,
    has_prev_action: torch.Tensor,
    reward_window: torch.Tensor,       # (N, W)
    reward_window_len: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, dict[str, torch.Tensor]]:
    """Returns (total_reward, new_window, new_window_len, components)."""
    zero = torch.zeros_like(altitude)
    effort = torch.linalg.vector_norm(action, dim=-1)

    mission_completion = torch.where(
        mission_successful, 1.0, torch.where(phase == PHASE_LANDING, 0.1, zero)
    )
    tilt_term = torch.exp(-10.0 * torch.clamp(tilt - 0.087, min=0.0))
    ang_term = torch.exp(-5.0 * torch.clamp(angular_velocity_mag - 0.1, min=0.0))
    alt_term = torch.where((altitude >= 0.2) & (altitude <= 20.0), 1.0, zero + 0.5)
    safety_compliance = (tilt_term + ang_term + alt_term) / 3.0
    fuel_efficiency = torch.where(
        (fuel > 0.1) & (effort < 0.5), fuel * (1.0 - effort), zero
    )

    stability_bonus = torch.where(
        (tilt < 0.05) & (angular_velocity_mag < 0.1),
        1.0,
        torch.where((tilt < 0.1) & (angular_velocity_mag < 0.2), 0.5, zero),
    )
    action_diff = torch.linalg.vector_norm(action - prev_action, dim=-1)
    control_smoothness = torch.where(
        has_prev_action, torch.exp(-5.0 * action_diff), zero + 1.0
    )
    altitude_maintenance = torch.exp(-2.0 * torch.abs(altitude - cfg.target_altitude))

    crash_penalty = torch.where(crashed, cfg.crash_penalty, zero)
    excessive_tilt = torch.where(
        tilt > cfg.excessive_tilt_threshold,
        cfg.excessive_tilt_scale * (tilt - cfg.excessive_tilt_threshold),
        zero,
    )
    control_saturation = torch.where(
        effort > cfg.saturation_threshold,
        cfg.saturation_scale * (effort - cfg.saturation_threshold),
        zero,
    )

    components = {
        "mission_completion": mission_completion * cfg.mission_completion_weight,
        "safety_compliance": safety_compliance * cfg.safety_compliance_weight,
        "fuel_efficiency": fuel_efficiency * cfg.fuel_efficiency_weight,
        "stability_bonus": stability_bonus * cfg.stability_bonus_weight,
        "control_smoothness": control_smoothness * cfg.control_smoothness_weight,
        "altitude_maintenance": altitude_maintenance * cfg.altitude_maintenance_weight,
        "crash_penalty": crash_penalty,
        "excessive_tilt": excessive_tilt,
        "control_saturation": control_saturation,
    }
    subtotal = sum(components.values())

    window = cfg.variance_window
    n = torch.clamp(reward_window_len, max=window).to(altitude.dtype)
    have_full = reward_window_len > window
    denom = torch.clamp(n, min=1.0)
    mean = reward_window.sum(dim=-1) / denom
    valid = torch.arange(window, device=altitude.device) < reward_window_len[:, None]
    var = torch.where(
        valid, (reward_window - mean[:, None]) ** 2, torch.zeros_like(reward_window)
    ).sum(dim=-1) / denom
    variance_penalty = torch.where(
        have_full & (var > 10000.0), -cfg.gradient_penalty * var, zero
    )
    spread = reward_window.amax(dim=-1) - reward_window.amin(dim=-1)
    diversity = torch.where(
        (reward_window_len >= 2) & (spread > 1e-6), cfg.diversity_bonus, zero
    )
    anti_hack = variance_penalty + diversity
    components["anti_hacking"] = anti_hack

    total = torch.clamp(subtotal + anti_hack, cfg.clip_min, cfg.clip_max)
    new_window = torch.cat([reward_window[:, 1:], total[:, None]], dim=-1)
    new_len = torch.clamp(reward_window_len + 1, max=2**30)
    return total, new_window, new_len, components
