"""Mission-phase FSM and success-window detection, branch-free.

Counterpart of ``tvc_ai_tpu/env/mission.py``.
"""

from __future__ import annotations

import torch

from tvc_ai_torch.env.types import (
    PHASE_BOOST,
    PHASE_COAST,
    PHASE_COMPLETE,
    PHASE_LANDING,
    PHASE_TOUCHDOWN,
    SuccessConfig,
)


def update_phase(
    phase: torch.Tensor,
    altitude: torch.Tensor,
    tilt: torch.Tensor,
    fuel: torch.Tensor,
    angular_velocity_mag: torch.Tensor,
    success: SuccessConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One FSM tick; returns (new_phase, completed_this_step).

    BOOST→COAST on fuel<0.8; COAST→LANDING on alt<5; LANDING→TOUCHDOWN on
    alt<1; TOUCHDOWN→COMPLETE on alt<0.5 with tilt and ‖ω‖ under the success
    limits. One transition at most per step.
    """
    to_coast = (phase == PHASE_BOOST) & (fuel < 0.8)
    to_landing = (phase == PHASE_COAST) & (altitude < 5.0)
    to_touchdown = (phase == PHASE_LANDING) & (altitude < 1.0)
    to_complete = (
        (phase == PHASE_TOUCHDOWN)
        & (altitude < 0.5)
        & (tilt < success.max_tilt_angle)
        & (angular_velocity_mag < success.max_angular_velocity)
    )
    new_phase = torch.where(to_coast, PHASE_COAST, phase)
    new_phase = torch.where(to_landing, PHASE_LANDING, new_phase)
    new_phase = torch.where(to_touchdown, PHASE_TOUCHDOWN, new_phase)
    new_phase = torch.where(to_complete, PHASE_COMPLETE, new_phase)
    return new_phase, to_complete


def update_success_window(
    success_count: torch.Tensor,
    altitude: torch.Tensor,
    tilt: torch.Tensor,
    angular_velocity_mag: torch.Tensor,
    horizontal_velocity: torch.Tensor,
    vertical_velocity: torch.Tensor,
    success: SuccessConfig,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Consecutive all-criteria count; returns (new_count, window_success)."""
    criteria_met = (
        (tilt < success.max_tilt_angle)
        & (vertical_velocity < success.max_vertical_velocity)
        & (horizontal_velocity < success.max_horizontal_velocity)
        & (altitude >= success.min_altitude)
        & (altitude <= success.max_altitude)
        & (angular_velocity_mag < success.max_angular_velocity)
    )
    new_count = torch.where(criteria_met, success_count + 1, 0)
    return new_count, new_count >= success.success_duration
