"""Physics-informed consistency loss on the ICM's forward model.

Counterpart of ``tvc_ai_tpu/agents/physics_informed.py``: three terms with
the reference's constants, summed and scaled by ``physics_weight``:

1. angular-momentum consistency: ω' ≈ ω + ``torque_coupling``·‖a‖ on each axis;
2. kinetic-energy consistency: ½‖ω'‖² ≈ ½‖ω‖² + ``energy_coupling``·½‖a‖²;
3. quaternion-norm regularization: ‖q‖ and ‖q'‖ ≈ 1.

``make_icm_physics_loss`` penalizes the forward model's predicted next state
(``models.curiosity.update(physics_loss_fn=...)``), where gradients reach a
learnable model.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PhysicsInformedConfig:
    physics_weight: float = 0.1
    torque_coupling: float = 0.1
    energy_coupling: float = 0.01


def physics_informed_loss(
    states: torch.Tensor,        # (B, ≥7): [quat(4), ω(3), ...]
    actions: torch.Tensor,       # (B, A)
    next_states: torch.Tensor,   # (B, ≥7)
    cfg: PhysicsInformedConfig = PhysicsInformedConfig(),
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    quat, omega = states[..., :4], states[..., 4:7]
    next_quat, next_omega = next_states[..., :4], next_states[..., 4:7]

    control_torque = torch.linalg.vector_norm(actions, dim=-1, keepdim=True) * cfg.torque_coupling
    momentum_loss = torch.mean((next_omega - (omega + control_torque)) ** 2)

    kinetic = 0.5 * torch.sum(omega**2, dim=-1)
    next_kinetic = 0.5 * torch.sum(next_omega**2, dim=-1)
    control_energy = 0.5 * torch.sum(actions**2, dim=-1)
    energy_loss = torch.mean(
        (next_kinetic - (kinetic + control_energy * cfg.energy_coupling)) ** 2)

    quat_norm_loss = (torch.mean((torch.linalg.vector_norm(quat, dim=-1) - 1.0) ** 2)
                      + torch.mean((torch.linalg.vector_norm(next_quat, dim=-1) - 1.0) ** 2))

    losses = {
        "momentum_conservation": momentum_loss,
        "energy_conservation": energy_loss,
        "quaternion_normalization": quat_norm_loss,
    }
    total = (momentum_loss + energy_loss + quat_norm_loss) * cfg.physics_weight
    return total, losses


def make_icm_physics_loss(cfg: PhysicsInformedConfig = PhysicsInformedConfig()):
    """``physics_loss_fn(pred_next, obs, action)`` for ``curiosity.update``:
    the consistency terms on the forward model's predicted next state."""

    def fn(pred_next, obs, action):
        total, _ = physics_informed_loss(obs, action, pred_next, cfg)
        return total

    return fn
