"""Domain-randomization sampling, one draw per env per reset.

Counterpart of ``tvc_ai_tpu/env/randomization.py``. The draws are explicit:
``u_dr`` (N, 7) uniform on [-1, 1] and ``n_dr`` (N, 3) standard normal, in
the reference's slot order; with ``feasible_only`` the physical axes come
instead from K candidates, ``u_feas`` (N, K, 4) uniform on [-1, 1] and
``n_feas`` (N, K, 3) standard normal (``n_dr`` is then unused). Draws not
given come from ``generator`` on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from tvc_ai_torch.env.types import DomainParams, RandomizationConfig
from tvc_ai_torch.physics.types import RocketParams

# slots of the fused uniform draw u ~ U[-1, 1]^7
_U_MASS, _U_CG_X, _U_CG_Y, _U_CG_Z, _U_MIX, _U_NOISE, _U_PROG = range(7)
# slots of the fused normal draw n ~ N(0, 1)^3
_N_THRUST, _N_WIND_X, _N_WIND_Y = range(3)


def needs_uniform(cfg: RandomizationConfig) -> bool:
    return cfg.enabled or cfg.sensor_noise_uniform or cfg.progress_rate_randomized


def draw_uniform(shape: tuple, device: torch.device,
                 generator: torch.Generator | None) -> torch.Tensor:
    """U[-1, 1) float32 draws."""
    return torch.rand(shape, device=device, generator=generator) * 2.0 - 1.0


def feasible_draw_mask(
    mass: torch.Tensor,
    thrust_scale: torch.Tensor,
    cg_offset: torch.Tensor,
    rocket: RocketParams,
    tilt_limit: float,
) -> torch.Tensor:
    """True where the strict success window is physically attainable.

    Rejects the three controller-independent infeasible classes: climb-away
    (thrust above weight), friction-pinned (stiction above the largest
    lateral thrust, where the vehicle does not climb) and an equilibrium
    tilt ``atan2(2·T·d, m·g_eff)`` beyond ``tilt_limit`` at lateral cg
    offset d. g_eff honours double gravity.
    """
    g_eff = rocket.gravity * (2.0 if rocket.double_gravity else 1.0)
    thrust = thrust_scale * rocket.thrust
    weight = mass * g_eff
    climb = thrust > weight
    # sin in float32, as the reference's float32 parameters compute it
    sin_gimbal = float(np.sin(np.float32(rocket.max_gimbal)))
    pinned = rocket.contact_friction * (weight - thrust) > thrust * sin_gimbal
    cg_mag = torch.sqrt(torch.sum(cg_offset[..., :2] ** 2, dim=-1))
    tilted = torch.atan2(2.0 * thrust * cg_mag, weight) > tilt_limit
    return ~(climb | (~climb & pinned) | tilted)


def feasible_candidates(
    rocket: RocketParams,
    cfg: RandomizationConfig,
    u_feas: torch.Tensor,
    n_feas: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``feasible_tries`` candidate plants of a feasible-only draw and
    which of them ``feasible_draw_mask`` accepts: mass (N, K), thrust scale
    (N, K), cg offset (N, K, 3), accepted (N, K)."""
    mass_k = rocket.mass * (1.0 + u_feas[..., 0] * cfg.mass_variation)
    thrust_k = _thrust_scale(n_feas[..., _N_THRUST], cfg)
    cg_k = _cg_offset(u_feas[..., 1:4], cfg)
    return mass_k, thrust_k, cg_k, feasible_draw_mask(mass_k, thrust_k, cg_k, rocket,
                                                      cfg.feasible_tilt_limit)


def mixture_hard(cfg: RandomizationConfig, u_dr: torch.Tensor) -> torch.Tensor:
    """(N,) True where the easy/hard gate keeps the randomized plant."""
    return (u_dr[:, _U_MIX] * 0.5 + 0.5) < cfg.dr_prob


def _thrust_scale(n: torch.Tensor, cfg: RandomizationConfig) -> torch.Tensor:
    return 1.0 + torch.clamp(n * cfg.thrust_variation,
                             -2.0 * cfg.thrust_variation, 2.0 * cfg.thrust_variation)


def _cg_offset(u: torch.Tensor, cfg: RandomizationConfig) -> torch.Tensor:
    """CG offset from three uniforms (..., 3): the box, z at half range."""
    cg = u * cfg.cg_offset_max
    return torch.cat([cg[..., :2], cg[..., 2:] * 0.5], dim=-1)


def sample_domain_params(
    rocket: RocketParams,
    cfg: RandomizationConfig,
    n: int,
    device: torch.device,
    generator: torch.Generator | None = None,
    u_dr: torch.Tensor | None = None,
    n_dr: torch.Tensor | None = None,
    u_feas: torch.Tensor | None = None,
    n_feas: torch.Tensor | None = None,
) -> DomainParams:
    """Per-episode physics for n envs.

    mass uniform ±mass_variation; thrust scale normal σ=thrust_variation
    clipped to ±2σ; CG offset uniform box (z at half range); wind normal
    σ=wind_max/2 clipped to ±wind_max on x and y; sensor noise σ fixed (or
    U[0, σ] per episode); progress rate U[min, max] when randomized.

    ``feasible_only``: the first of ``feasible_tries`` candidates that
    ``feasible_draw_mask`` accepts gives mass, thrust scale, cg and wind; if
    none does, mass, thrust scale and cg are nominal and the wind still comes
    from candidate 0's normals. ``dr_mixture_enabled``: where
    ``u_dr[:, 4]·0.5 + 0.5 >= dr_prob`` the env is easy and mass, thrust
    scale, cg and wind are nominal; the noise level and progress rate stay
    randomized either way.
    """
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

    if cfg.feasible_only:
        k = cfg.feasible_tries
        if u_feas is None:
            u_feas = draw_uniform((n, k, 4), device, generator)
        if n_feas is None:
            n_feas = torch.randn((n, k, 3), device=device, generator=generator)
        mass_k, thrust_k, cg_k, ok = feasible_candidates(rocket, cfg, u_feas, n_feas)
        # the first feasible candidate (argmax returns the first maximum);
        # candidate 0 where none is, whose wind is kept
        i = torch.argmax(ok.to(torch.uint8), dim=1, keepdim=True)          # (N, 1)
        any_ok = ok.any(dim=1)
        mass = torch.where(any_ok, mass_k.gather(1, i)[:, 0], rocket.mass)
        thrust_scale = torch.where(any_ok, thrust_k.gather(1, i)[:, 0], 1.0)
        cg_offset = torch.where(
            any_ok[:, None], cg_k.gather(1, i[:, :, None].expand(n, 1, 3))[:, 0], 0.0)
        wind_src = n_feas.gather(1, i[:, :, None].expand(n, 1, 3))[:, 0, _N_WIND_X:]
    else:
        if n_dr is None:
            n_dr = torch.randn((n, 3), device=device, generator=generator)
        mass = rocket.mass * (1.0 + u_dr[:, _U_MASS] * cfg.mass_variation)
        thrust_scale = _thrust_scale(n_dr[:, _N_THRUST], cfg)
        cg_offset = _cg_offset(u_dr[:, _U_CG_X:_U_CG_Z + 1], cfg)
        wind_src = n_dr[:, _N_WIND_X:]
    wind_xy = torch.clamp(wind_src * (cfg.wind_max * 0.5), -cfg.wind_max, cfg.wind_max)
    wind = torch.cat([wind_xy, torch.zeros(n, 1, dtype=f32, device=device)], dim=-1)
    if cfg.dr_mixture_enabled:
        hard = mixture_hard(cfg, u_dr)
        mass = torch.where(hard, mass, rocket.mass)
        thrust_scale = torch.where(hard, thrust_scale, 1.0)
        cg_offset = torch.where(hard[:, None], cg_offset, 0.0)
        wind = torch.where(hard[:, None], wind, 0.0)
    return DomainParams(
        mass=mass, thrust_scale=thrust_scale, cg_offset=cg_offset, wind=wind,
        sensor_noise_std=noise_std, progress_rate=progress_rate,
    )
