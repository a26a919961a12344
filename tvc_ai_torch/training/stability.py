"""Training-stability toolkit: adaptive τ, primacy reset, dormant-unit reinit.

Counterpart of ``tvc_ai_tpu/training/stability.py``. The trainer's
learning-rate schedules live in ``agents/optim.py`` (``SACConfig.lr_schedule``),
as the reference folds them into its optimizers; ``make_lr_schedule`` builds
the toolkit's own from a ``StabilityConfig`` out of the same pieces. The
interventions change the actor's parameters in place, between iterations:

- ``primacy_reset`` resets a random ``ratio`` of every parameter to its
  initial value; its Bernoulli masks are explicit (``masks``, one per
  parameter in ``named_parameters`` order, in the module's layout) or drawn
  from ``generator``;
- ``reinit_dormant_units`` gives the first hidden layer's dormant units
  fresh incoming weights ``normal · sqrt(2 / fan_in)`` and a zero bias; the
  standard-normal draw is explicit (``fresh``, the layer's weight shape) or
  drawn from ``generator``.

``TrainingStabilityManager`` only decides when, on the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tvc_ai_torch.agents import optim
from tvc_ai_torch.models.mlp import GaussianActor


@dataclass(frozen=True)
class StabilityConfig:
    enable_lr_scheduling: bool = True
    scheduler_type: str = "warmup_cosine"  # linear|exponential|cosine|warmup_cosine|plateau
    initial_lr_factor: float = 0.1
    warmup_steps: int = 10_000
    decay_factor: float = 0.5
    plateau_patience: int = 20_000

    enable_plasticity_preservation: bool = True
    dormant_threshold: float = 0.01
    dormant_check_interval: int = 5_000
    reinit_dormant_ratio: float = 0.1

    enable_primacy_mitigation: bool = True
    reset_interval: int = 50_000
    reset_ratio: float = 0.05

    adaptive_tau: bool = True
    tau_min: float = 0.001
    tau_max: float = 0.01
    tau_decay: float = 0.999

    hacking_stop_threshold: float = 0.9


def make_lr_schedule(cfg: StabilityConfig, base_lr: float, total_steps: int
                     ) -> Callable[[int], float]:
    """The learning rate at an update count (float32), as the reference's
    optax schedule: constant when scheduling is off; ``linear`` base → 0
    over ``total_steps``; ``exponential`` ``decay_factor`` every
    ``max(total_steps // 10, 1)`` counts (staircase); ``cosine`` base → 0;
    ``warmup_cosine`` from base · ``initial_lr_factor`` over
    ``warmup_steps``, then cosine to 0; ``plateau`` ``decay_factor`` every
    ``plateau_patience`` counts (staircase: the reference has no metric to
    watch either)."""
    if not cfg.enable_lr_scheduling:
        return optim.make_schedule("constant", base_lr, total_steps)
    t = cfg.scheduler_type
    if t in ("linear", "cosine", "warmup_cosine"):
        return optim.make_schedule(t, base_lr, total_steps, cfg.warmup_steps,
                                   cfg.initial_lr_factor)
    if t == "exponential":
        return optim.staircase_decay(base_lr, max(total_steps // 10, 1), cfg.decay_factor)
    if t == "plateau":
        return optim.staircase_decay(base_lr, cfg.plateau_patience, cfg.decay_factor)
    raise ValueError(f"unknown scheduler_type {t!r}")


def adaptive_tau(cfg: StabilityConfig, update_step: int) -> float:
    """τ decays τ_max → τ_min by ``tau_decay`` per update (float32
    arithmetic); τ_min when adaptive τ is off, as the reference returns."""
    f32 = np.float32
    if not cfg.adaptive_tau:
        return float(f32(cfg.tau_min))
    return float(max(f32(cfg.tau_min),
                     f32(cfg.tau_max) * f32(cfg.tau_decay) ** f32(update_step)))


@torch.no_grad()
def primacy_reset(
    module: torch.nn.Module,
    initial_params: list[torch.Tensor],
    ratio: float,
    masks: list[torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
) -> torch.nn.Module:
    """Reset a random ``ratio`` of ``module``'s weights to ``initial_params``
    (its parameters at registration, same order), in place."""
    params = list(module.parameters())
    if masks is None:
        masks = [torch.rand(p.shape, device=p.device, generator=generator) < ratio
                 for p in params]
    for p, init, mask in zip(params, initial_params, masks, strict=True):
        p.copy_(torch.where(mask, init, p))
    return module


def _first_layer_activity(actor: GaussianActor, probe_obs: torch.Tensor) -> torch.Tensor:
    """Mean |ReLU| activation of each first-hidden-layer unit over the probe."""
    layer = actor.hidden_0
    return torch.relu(probe_obs @ layer.weight.T + layer.bias).abs().mean(dim=0)


@torch.no_grad()
def dormant_neuron_fraction(actor: GaussianActor, probe_obs: torch.Tensor,
                            threshold: float) -> torch.Tensor:
    """Fraction of first-hidden-layer units with mean |activation| < threshold."""
    return (_first_layer_activity(actor, probe_obs) < threshold).to(torch.float32).mean()


@torch.no_grad()
def reinit_dormant_units(
    actor: torch.nn.Module,
    probe_obs: torch.Tensor,
    threshold: float,
    max_ratio: float,
    fresh: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.nn.Module:
    """Reinitialize the incoming weights of dormant first-layer units, in place.

    A unit is dormant when its probe activity is below ``threshold``; at most
    ``int(units · max_ratio)`` units, the most dormant first, are reset.
    A module without a first hidden layer is left as it is.
    """
    layer = getattr(actor, "hidden_0", None)
    if layer is None:
        return actor
    act = _first_layer_activity(actor, probe_obs)
    order = torch.argsort(act, stable=True)  # most dormant first
    n_max = int(layer.weight.shape[0] * max_ratio)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=order.device)
    dormant = (act < threshold) & (rank < n_max)
    if fresh is None:
        fresh = torch.randn(layer.weight.shape, device=layer.weight.device, generator=generator)
    scale = float(np.sqrt(np.float32(2.0 / layer.weight.shape[1])))
    layer.weight.copy_(torch.where(dormant[:, None], fresh * scale, layer.weight))
    layer.bias.copy_(torch.where(dormant, 0.0, layer.bias))
    return actor


class TrainingStabilityManager:
    """Host-side cadence controller for the interventions above."""

    def __init__(self, cfg: StabilityConfig, total_steps: int):
        self.cfg = cfg
        self.total_steps = total_steps
        self.update_count = 0
        self._initial_params: list[torch.Tensor] | None = None
        self._last_primacy = 0
        self._last_dormant = 0

    def register_initial_params(self, module: torch.nn.Module) -> None:
        self._initial_params = [p.detach().clone() for p in module.parameters()]

    def step(self, n_updates: int = 1) -> None:
        self.update_count += int(n_updates)

    def due_primacy_reset(self) -> bool:
        if not self.cfg.enable_primacy_mitigation or self._initial_params is None:
            return False
        if self.update_count - self._last_primacy >= self.cfg.reset_interval:
            self._last_primacy = self.update_count
            return True
        return False

    def due_dormant_check(self) -> bool:
        if not self.cfg.enable_plasticity_preservation:
            return False
        if self.update_count - self._last_dormant >= self.cfg.dormant_check_interval:
            self._last_dormant = self.update_count
            return True
        return False

    def apply_primacy_reset(self, module: torch.nn.Module,
                            generator: torch.Generator | None = None) -> torch.nn.Module:
        return primacy_reset(module, self._initial_params, self.cfg.reset_ratio,
                             generator=generator)

    def should_stop_training(self, hacking_score: float) -> bool:
        """Abort on runaway hacking."""
        return hacking_score > self.cfg.hacking_stop_threshold

    def state_dict(self) -> dict:
        return {
            "update_count": self.update_count,
            "last_primacy": self._last_primacy,
            "last_dormant": self._last_dormant,
        }

    def load_state_dict(self, d: dict) -> None:
        self.update_count = int(d.get("update_count", 0))
        self._last_primacy = int(d.get("last_primacy", 0))
        self._last_dormant = int(d.get("last_dormant", 0))


def create_stability_manager(total_steps: int, conservative: bool = False
                             ) -> TrainingStabilityManager:
    """The reference's preset: ``StabilityConfig``'s defaults, or with
    ``conservative`` a slower warm-up (factor 0.05 over 20,000 counts) and
    gentler resets (2 % of weights, 5 % of dormant units)."""
    cfg = StabilityConfig()
    if conservative:
        cfg = dataclasses.replace(cfg, initial_lr_factor=0.05, warmup_steps=20_000,
                                  reset_ratio=0.02, reinit_dormant_ratio=0.05)
    return TrainingStabilityManager(cfg, total_steps)
