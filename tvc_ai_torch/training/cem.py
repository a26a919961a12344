"""Per-draw controller refinement by batched CEM on the simulator.

Counterpart of ``tvc_ai_tpu/training/cem.py``. The controller class is the
per-plane linear state feedback of the ground-balance LQR plus a constant
trim, θ = [gain_yaw(6), gain_pitch(6), trim_pitch, trim_yaw, z_eq]
(``THETA_DIM`` = 15). The cross-entropy method searches θ per env draw with
the simulator as the objective: the longest in-window streak (the env's
``success_count``), a success bonus and a tilt penalty, with no
differentiable surrogate. ``draws × pop`` candidates roll as one batch of
envs, one generation after another.

Where it runs. ``rollout_score`` steps ``rocket_env.batched_step`` (K1 on
the card; the reference steps the plain integrator there) and freezes each
row at its first termination (``eval.rollout._freeze``). The reference
steps with the autoreset and freezes the fresh episode's state, whose
``success_count`` is 0 on the step an episode ends; the port steps without
the autoreset and counts 0 on that step, which gives the same scores with
no reset computed. Like the evaluation rollout it stops early, at the first
multiple of ``CHECK_EVERY`` steps where every row has ended (one device read
there); the scores cannot change after that.

Randomness is explicit: the candidates' standard-normal noise ``(G, D, P,
15)`` and, with ``obs_noise_std > 0``, the controller's IMU noise ``(G, H,
D·P, 7)`` ([quat(4), ω(3)]) come in ``CEMDraws``, or from ``generator``.

Ties. The elites are the first ``elites`` of a stable descending sort of
the scores (``argsort(-scores)`` in the reference, stable by default), the
generation's best its first maximum, so equal scores resolve to the lower
candidate index on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.types import EnvParams, EnvState
from tvc_ai_torch.eval.rollout import CHECK_EVERY, _freeze
from tvc_ai_torch.physics import quaternion as quat
from tvc_ai_torch.physics.types import RocketParams
from tvc_ai_torch.training.demos import LQRDesign, LQRSchedule, interp_design
from tvc_ai_torch.utils.tree import tree_map

# theta layout: [gain_yaw(6), gain_pitch(6), trim_pitch, trim_yaw, z_eq]
THETA_DIM = 15
F32 = torch.float32


class CEMConfig(NamedTuple):
    """The reference's ``CEMConfig``, field for field (its comments give the
    measurements behind ``alive_weight``, ``obs_noise_std`` and
    ``anchor_weight``)."""

    pop: int = 32               # candidates per draw per generation
    elites: int = 8
    generations: int = 15
    horizon: int = 500          # rollout steps (the window needs 100 in-window)
    sigma_gain: float = 0.25    # initial σ, relative to |init gain| (+floor)
    sigma_gain_floor: float = 0.05
    sigma_trim: float = 0.05    # initial σ on trim, action units
    sigma_floor: float = 1e-3   # σ never collapses below this
    streak_weight: float = 1.0  # score per in-window streak step
    success_bonus: float = 1000.0
    tilt_shaping: float = 10.0  # subtracts mean tilt (rad) × this
    alive_weight: float = 0.0   # score per live step
    obs_noise_std: float = 0.0  # IMU noise on the controller's copy of quat/ω
    anchor_weight: float = 0.0  # subtracts anchor_weight·‖θ − θ0‖²


@dataclasses.dataclass
class CEMDraws:
    """The random numbers one ``refine_per_draw`` consumes: the candidates'
    noise (G, D, P, 15) (candidate 0's row is not used) and, with
    ``obs_noise_std > 0``, each generation's IMU noise (G, H, D·P, 7)."""

    noise: torch.Tensor
    obs_noise: torch.Tensor | None = None


def theta_from_design(design: LQRDesign) -> torch.Tensor:
    """θ rows (..., 15) of an (optionally batched) design of tensors: its
    gains, zero trims and its own plant's z_eq."""
    gain = torch.as_tensor(design.gain)
    zeros = torch.zeros(gain.shape[:-1] + (1,), dtype=gain.dtype, device=gain.device)
    z = torch.broadcast_to(torch.as_tensor(design.z_eq, device=gain.device)[..., None],
                           zeros.shape)
    return torch.cat([gain, torch.as_tensor(design.gain_pitch, device=gain.device), zeros, zeros,
                      z], dim=-1)


def controller_action(theta: torch.Tensor, body, rp: RocketParams) -> torch.Tensor:
    """The linear ground-balance action of θ (N, 15) on bodies (N): the
    blind LQR's form with θ's z_eq and a constant trim."""
    up = torch.zeros_like(body.pos)
    up[..., 2] = 1.0
    zhat = quat.rotate(body.quat, up)
    theta_x = torch.atan2(zhat[..., 0], zhat[..., 2])
    phi = torch.atan2(-zhat[..., 1], zhat[..., 2])
    dz = body.pos[..., 2] - theta[..., 14]
    pos, vel, omega = body.pos, body.vel, body.omega
    sx = torch.stack([pos[..., 0], dz, theta_x, vel[..., 0], vel[..., 2], omega[..., 1]], dim=-1)
    sy = torch.stack([pos[..., 1], dz, phi, vel[..., 1], vel[..., 2], omega[..., 0]], dim=-1)
    u_yaw = -torch.sum(theta[..., 0:6] * sx, dim=-1)
    u_pitch = -torch.sum(theta[..., 6:12] * sy, dim=-1)
    act = torch.stack([u_pitch, u_yaw], dim=-1) / rp.max_gimbal
    return torch.clamp(act + theta[..., 12:14], -1.0, 1.0)


@torch.no_grad()
def rollout_score(
    theta: torch.Tensor,
    states0: EnvState,
    params: EnvParams,
    cfg: CEMConfig,
    obs_noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Score each row's controller θ (N, 15) on its row's env (N): success
    bonus + best in-window streak + alive steps − tilt shaping × mean tilt,
    one episode per row over ``cfg.horizon`` steps. With ``obs_noise_std >
    0`` the controller sees IMU-noisy quat/ω: ``obs_noise`` (H, N, 7)
    standard normal, or from ``generator``; the plant stays exact. The
    environment's own draws (sensor noise of the observation, which nothing
    here reads) come from ``generator``."""
    rp = params.rocket
    n, dev = theta.shape[0], theta.device
    noisy = cfg.obs_noise_std > 0.0
    st = states0
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    succ = torch.zeros(n, dtype=torch.bool, device=dev)
    best_streak = torch.zeros(n, dtype=torch.int32, device=dev)
    tilt_sum = torch.zeros(n, dtype=F32, device=dev)
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    for t in range(cfg.horizon):
        if t > 0 and t % CHECK_EVERY == 0 and bool(done.all()):
            break
        body = st.body
        if noisy:
            z = (obs_noise[t] if obs_noise is not None
                 else torch.randn((n, 7), device=dev, generator=generator))
            body = dataclasses.replace(
                body, quat=quat.normalize(body.quat + cfg.obs_noise_std * z[:, :4]),
                omega=body.omega + cfg.obs_noise_std * z[:, 4:])
        act = controller_action(theta, body, rp)
        nxt, out = rocket_env.batched_step(st, act, params, generator=generator)
        ep_done = out.terminated | out.truncated
        # success from the step's output: it ends the episode on that step
        succ = succ | (~done & out.mission_success)
        best_streak = torch.maximum(
            best_streak, torch.where(done | ep_done, 0, nxt.success_count))
        tilt_sum = tilt_sum + torch.where(done, 0.0, out.tilt)
        steps = steps + (~done).to(torch.int32)
        st = _freeze(done, nxt, st)
        done = done | ep_done
    mean_tilt = tilt_sum / torch.clamp(steps, min=1)
    return (cfg.success_bonus * succ.to(F32) + cfg.streak_weight * best_streak.to(F32)
            + cfg.alive_weight * steps.to(F32) - cfg.tilt_shaping * mean_tilt)


def _replicate(tree, pop: int):
    """Each env of a batch repeated ``pop`` times in place: (d, ...) →
    (d·pop, ...)."""
    return tree_map(lambda x: torch.repeat_interleave(x, pop, dim=0), tree)


def draw(draws: int, cfg: CEMConfig, device: torch.device,
         generator: torch.Generator | None = None) -> CEMDraws:
    """The draws of one ``refine_per_draw`` over ``draws`` envs."""
    g = cfg.generations
    return CEMDraws(
        noise=torch.randn((g, draws, cfg.pop, THETA_DIM), device=device, generator=generator),
        obs_noise=(torch.randn((g, cfg.horizon, draws * cfg.pop, 7), device=device,
                               generator=generator) if cfg.obs_noise_std > 0.0 else None),
    )


@torch.no_grad()
def refine_per_draw(
    params: EnvParams,
    states0: EnvState,
    theta0: torch.Tensor,
    cfg: CEMConfig = CEMConfig(),
    theta_mask: torch.Tensor | None = None,
    freeze_mask: torch.Tensor | None = None,
    draws: CEMDraws | None = None,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """CEM-refine one controller per draw, as the reference.

    ``states0``: one env per draw (its domain already drawn); ``theta0``
    (D, 15) the initial means. ``theta_mask`` (15,) multiplies every
    candidate (a controller subspace); ``freeze_mask`` (15,) pins the
    components where it is 1 to θ0. Each generation scores ``D × pop``
    candidates (candidate 0 the mean), takes the elites' mean and σ (ddof
    0, floored at ``sigma_floor``) and keeps the best ever per draw.
    Returns (θ_best (D, 15), score_best (D,)).
    """
    d, pop, dev = theta0.shape[0], cfg.pop, theta0.device
    if draws is None:
        draws = draw(d, cfg, dev, generator)
    rep_states = _replicate(states0, pop)
    if theta_mask is not None:
        theta0 = theta0 * theta_mask
    sigma = torch.cat([
        torch.abs(theta0[:, :12]) * cfg.sigma_gain + cfg.sigma_gain_floor,
        torch.full((d, 2), cfg.sigma_trim, dtype=theta0.dtype, device=dev),
        torch.full((d, 1), 0.002, dtype=theta0.dtype, device=dev),   # z_eq: ±mm scale
    ], dim=-1)
    mean, best_theta = theta0, theta0
    best_score = torch.full((d,), float("-inf"), dtype=F32, device=dev)
    rows = torch.arange(d, device=dev)
    for g in range(cfg.generations):
        noise = draws.noise[g].clone()
        noise[:, 0, :] = 0.0   # candidate 0 is the current mean
        cand = mean[:, None, :] + sigma[:, None, :] * noise
        if theta_mask is not None:
            cand = cand * theta_mask
        if freeze_mask is not None:
            cand = torch.where(freeze_mask.to(torch.bool), theta0[:, None, :], cand)
        scores = rollout_score(
            cand.reshape(d * pop, THETA_DIM), rep_states, params, cfg,
            obs_noise=None if draws.obs_noise is None else draws.obs_noise[g],
            generator=generator).reshape(d, pop)
        if cfg.anchor_weight > 0.0:
            scores = scores - cfg.anchor_weight * torch.sum((cand - theta0[:, None, :]) ** 2,
                                                            dim=-1)
        elite_idx = torch.argsort(-scores, dim=1, stable=True)[:, :cfg.elites]
        elite = torch.take_along_dim(cand, elite_idx[..., None], dim=1)
        mean = elite.mean(1)
        sigma = torch.clamp(elite.std(1, correction=0), min=cfg.sigma_floor)
        gen_best = scores.argmax(1)
        gen_best_score = scores[rows, gen_best]
        improved = gen_best_score > best_score
        best_score = torch.where(improved, gen_best_score, best_score)
        best_theta = torch.where(improved[:, None], cand[rows, gen_best], best_theta)
    return best_theta, best_score


def theta_for_states(sched: LQRSchedule, states: EnvState) -> torch.Tensor:
    """The schedule's θ at a batch of drawn envs (the CEM's initial means)."""
    return theta_from_design(interp_design(sched, states.dr.mass, states.dr.thrust_scale))
