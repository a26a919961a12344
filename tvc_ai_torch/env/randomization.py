"""Domain-randomization sampling, one draw per env per reset.

Counterpart of ``tvc_ai_tpu/env/randomization.py::sample_domain_params``
(default path). The draws are explicit: ``u_dr`` (N, 7) uniform on [-1, 1]
and ``n_dr`` (N, 3) standard normal, in the reference's slot order; when not
given they come from ``generator`` on the device.
"""

from __future__ import annotations

import torch

from tvc_ai_torch.env.types import DomainParams, RandomizationConfig
from tvc_ai_torch.physics.types import RocketParams

# slots of the fused uniform draw u ~ U[-1, 1]^7
_U_MASS, _U_CG_X, _U_CG_Y, _U_CG_Z, _U_MIX, _U_NOISE, _U_PROG = range(7)
# slots of the fused normal draw n ~ N(0, 1)^3
_N_THRUST, _N_WIND_X, _N_WIND_Y = range(3)


def check_supported(cfg: RandomizationConfig) -> None:
    """Raise for the randomization options this port does not implement."""
    for name in ("feasible_only", "dr_mixture_enabled", "sensor_dropout_enabled",
                 "actuator_delay"):
        if getattr(cfg, name):
            raise NotImplementedError(f"RandomizationConfig.{name} is not ported")


def needs_uniform(cfg: RandomizationConfig) -> bool:
    return cfg.enabled or cfg.sensor_noise_uniform or cfg.progress_rate_randomized


def draw_uniform(shape: tuple, device: torch.device,
                 generator: torch.Generator | None) -> torch.Tensor:
    """U[-1, 1) float32 draws."""
    return torch.rand(shape, device=device, generator=generator) * 2.0 - 1.0


def sample_domain_params(
    rocket: RocketParams,
    cfg: RandomizationConfig,
    n: int,
    device: torch.device,
    generator: torch.Generator | None = None,
    u_dr: torch.Tensor | None = None,
    n_dr: torch.Tensor | None = None,
) -> DomainParams:
    """Per-episode physics for n envs.

    mass uniform ±mass_variation; thrust scale normal σ=thrust_variation
    clipped to ±2σ; CG offset uniform box (z at half range); wind normal
    σ=wind_max/2 clipped to ±wind_max on x and y; sensor noise σ fixed (or
    U[0, σ] per episode); progress rate U[min, max] when randomized.
    """
    check_supported(cfg)
    f32 = torch.float32
    noise_std = torch.full(
        (n,), cfg.sensor_noise_std if cfg.sensor_noise_enabled else 0.0,
        dtype=f32, device=device,
    )
    nominal = DomainParams(
        mass=torch.full((n,), rocket.mass, dtype=f32, device=device),
        thrust_scale=torch.ones(n, dtype=f32, device=device),
        cg_offset=torch.zeros(n, 3, dtype=f32, device=device),
        wind=torch.zeros(n, 3, dtype=f32, device=device),
        sensor_noise_std=noise_std,
        progress_rate=torch.ones(n, dtype=f32, device=device),
    )
    if not needs_uniform(cfg):
        return nominal

    if u_dr is None:
        u_dr = draw_uniform((n, 7), device, generator)
    if cfg.sensor_noise_enabled and cfg.sensor_noise_uniform:
        noise_std = noise_std * (u_dr[:, _U_NOISE] * 0.5 + 0.5)
    if cfg.progress_rate_randomized:
        progress_rate = cfg.progress_rate_min + (u_dr[:, _U_PROG] * 0.5 + 0.5) * (
            cfg.progress_rate_max - cfg.progress_rate_min
        )
    else:
        progress_rate = nominal.progress_rate
    if not cfg.enabled:
        return DomainParams(
            mass=nominal.mass, thrust_scale=nominal.thrust_scale,
            cg_offset=nominal.cg_offset, wind=nominal.wind,
            sensor_noise_std=noise_std, progress_rate=progress_rate,
        )

    if n_dr is None:
        n_dr = torch.randn((n, 3), device=device, generator=generator)
    mass = rocket.mass * (1.0 + u_dr[:, _U_MASS] * cfg.mass_variation)
    thrust_scale = 1.0 + torch.clamp(
        n_dr[:, _N_THRUST] * cfg.thrust_variation,
        -2.0 * cfg.thrust_variation, 2.0 * cfg.thrust_variation,
    )
    cg_offset = u_dr[:, _U_CG_X:_U_CG_Z + 1] * cfg.cg_offset_max
    cg_offset = torch.cat([cg_offset[:, :2], cg_offset[:, 2:] * 0.5], dim=-1)
    wind_xy = torch.clamp(
        n_dr[:, _N_WIND_X:] * (cfg.wind_max * 0.5), -cfg.wind_max, cfg.wind_max
    )
    wind = torch.cat([wind_xy, torch.zeros(n, 1, dtype=f32, device=device)], dim=-1)
    return DomainParams(
        mass=mass, thrust_scale=thrust_scale, cg_offset=cg_offset, wind=wind,
        sensor_noise_std=noise_std, progress_rate=progress_rate,
    )
