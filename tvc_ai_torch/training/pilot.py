"""Blind model-based identification pilot: a particle filter plus CEM replanning.

Counterpart of ``tvc_ai_tpu/training/pilot.py`` (its docstring gives the
measurements behind it and the honesty contract: the pilot reads only the
presented observations, its own actions and the public constants, never
the evaluated episode's state or draw). Each env carries a swarm of P plant
hypotheses, each a domain draw (mass, thrust scale, cg offset, wind) with
the rigid-body state that draw implies under the executed actions:

- predict: every particle steps one control step under the applied action
  through K1 (``ops.step_kernel``; the reference calls the plain
  integrator), with its own mass, thrust scale, cg offset and wind;
- weight: the presented IMU reading and the INS drift channels against each
  particle's predicted reading;
- observer feedback: each particle's observed channels are blended toward
  the reading;
- systematic resampling with Liu-West parameter jitter, clipped to the DR
  prior's box, when the effective sample size has degenerated;
- control: the gain-scheduled LQR at the posterior-mean plant and state, a
  CEM replan inside the pilot's own model (``replan``), or a controller
  library scored on posterior particles (``select_from_library``).

The reference vmaps per-env functions over (N, P); the port holds the swarm
as (N, P, ...) tensors and hands K1 the N·P rows as fresh contiguous
tensors (K1 needs 16-byte-aligned dense rows: no views with offsets, no
broadcast strides). The filter carries no key: each step's resampling
uniform (N,) and jitter normals (N, P, 8), the initial draws (N, P, 7) and
(N, P, 3) and the selection's Gumbel draws (N, S, P) are explicit or come
from ``generator`` (``categorical`` is the argmax of the logits plus Gumbel
noise, as under the reference's jax).
"""

from __future__ import annotations

import dataclasses

import torch

from tvc_ai_torch.env import randomization
from tvc_ai_torch.env.rocket_env import _constant
from tvc_ai_torch.env.types import (
    ACTION_DIM,
    OBS_DIM,
    TRIM_OBS_DIM,
    DomainParams,
    EnvParams,
    EnvState,
)
from tvc_ai_torch.ops.step_kernel import step_kernel
from tvc_ai_torch.physics import quaternion as quat
from tvc_ai_torch.physics.integrator import ThrustControl
from tvc_ai_torch.physics.types import RigidBodyState
from tvc_ai_torch.training import cem as cem_mod
from tvc_ai_torch.training import demos
from tvc_ai_torch.utils.tree import tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class PilotConfig:
    """The reference's ``PilotConfig``, field for field (its comments give
    the reasons for each value)."""

    particles: int = 192
    sigma_imu: float = 0.02
    sigma_drift: float = 0.02
    ess_frac: float = 0.5          # resample when ESS < ess_frac · P
    jitter_frac: float = 0.25      # param jitter × posterior std on resample
    obs_gain_imu: float = 0.25     # quat/ω blend toward the noisy reading
    obs_gain_drift: float = 0.4    # pos/vel-xy blend toward the exact INS
    jitter_floor_mass: float = 0.004
    jitter_floor_thrust: float = 0.002
    jitter_floor_cg: float = 0.0004
    jitter_floor_wind: float = 0.01
    state_from_obs: bool = False


@dataclasses.dataclass
class FilterState:
    """Per-env particle swarms: N envs × P particles."""

    bodies: RigidBodyState        # (N, P, ...) hypothesis rigid-body states
    dr: DomainParams              # (N, P, ...) hypothesis draws
    log_w: torch.Tensor           # (N, P) unnormalized log weights
    fuel: torch.Tensor            # (N,) deterministic, shared by the swarm


@dataclasses.dataclass
class PilotState:
    filt: FilterState
    theta: torch.Tensor           # (N, THETA_DIM) the committed controller
    has_theta: torch.Tensor       # (N,) bool, False until the first replan
    prev_action: torch.Tensor     # (N, ACTION_DIM) last commanded action
    last_obs: torch.Tensor        # (N, obs_dim) the latest presented observation


@dataclasses.dataclass
class ResampleDraws:
    """One filter step's draws: the systematic resampling's uniform (N,) in
    [0, 1) and the jitter's standard normals (N, P, 8)."""

    u: torch.Tensor
    n_jit: torch.Tensor


def _parse_obs(obs: torch.Tensor, params: EnvParams):
    """(quat_read, omega_read, fuel, drift_read or None) of observations."""
    i = OBS_DIM + (TRIM_OBS_DIM if params.trim_obs_enabled else 0)
    drift = obs[..., i:i + 4] if params.drift_obs_enabled else None
    return obs[..., 0:4], obs[..., 4:7], obs[..., 7], drift


def _predicted_drift(body: RigidBodyState, params: EnvParams) -> torch.Tensor:
    return torch.cat([body.vel[..., :2] * params.drift_obs_vel_scale,
                      body.pos[..., :2] * params.drift_obs_pos_scale], dim=-1)


def _swarm(x: torch.Tensor, p: int) -> torch.Tensor:
    """(N, ...) → a fresh contiguous (N, P, ...) copy per particle."""
    return x[:, None].expand(x.shape[0], p, *x.shape[1:]).contiguous()


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(N, P, ...) → (N·P, ...); a view of a contiguous tensor."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def init_filter(obs0: torch.Tensor, params: EnvParams, cfg: PilotConfig,
                u_dr: torch.Tensor | None = None, n_dr: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> FilterState:
    """Swarms seeded from the first observations (N, obs_dim): P draws from
    the DR prior per env (``u_dr`` (N, P, 7), ``n_dr`` (N, P, 3), or from
    ``generator``), one shared body from the readings (quat/ω from the IMU,
    x, y, vx, vy from the drift channels, z from ``init_pos`` and vz = 0)."""
    n, p, dev = obs0.shape[0], cfg.particles, obs0.device
    dr = randomization.sample_domain_params(
        params.rocket, params.randomization, n * p, dev, generator,
        u_dr=None if u_dr is None else _flat(u_dr), n_dr=None if n_dr is None else _flat(n_dr))
    dr = tree_map(lambda x: x.reshape(n, p, *x.shape[1:]), dr)
    q_read, w_read, _, drift = _parse_obs(obs0, params)
    if drift is not None:
        vel_xy = drift[:, :2] / params.drift_obs_vel_scale
        pos_xy = drift[:, 2:] / params.drift_obs_pos_scale
    else:
        vel_xy = torch.zeros((n, 2), dtype=F32, device=dev)
        pos_xy = torch.tensor(params.init_pos[:2], dtype=F32, device=dev).expand(n, 2)
    pos = torch.cat([pos_xy, torch.full((n, 1), params.init_pos[2], dtype=F32, device=dev)], -1)
    vel = torch.cat([vel_xy, torch.zeros((n, 1), dtype=F32, device=dev)], -1)
    body = RigidBodyState(pos=pos, quat=quat.normalize(q_read), vel=vel, omega=w_read)
    return FilterState(bodies=tree_map(lambda x: _swarm(x, p), body), dr=dr,
                       log_w=torch.zeros((n, p), dtype=F32, device=dev),
                       fuel=torch.ones(n, dtype=F32, device=dev))


def _predict(fs: FilterState, action: torch.Tensor, params: EnvParams) -> FilterState:
    """Every hypothesis one control step under the applied action (N, 2),
    through K1 on the N·P rows, with the env's fuel gate."""
    rp = params.rocket
    n, p = fs.log_w.shape
    thrust_active = fs.fuel > 0.0
    gimbal = torch.clamp(action, -1.0, 1.0) * rp.max_gimbal
    out = step_kernel(
        tree_map(_flat, fs.bodies),
        ThrustControl(gimbal=torch.repeat_interleave(gimbal, p, dim=0),
                      thrust_active=torch.repeat_interleave(thrust_active, p, dim=0)),
        rp, mass=_flat(fs.dr.mass), thrust_scale=_flat(fs.dr.thrust_scale),
        cg_offset=_flat(fs.dr.cg_offset), wind=_flat(fs.dr.wind))
    fuel = torch.where(thrust_active, torch.clamp(fs.fuel - rp.fuel_burn_rate, min=0.0), fs.fuel)
    bodies = tree_map(lambda x: x.reshape(n, p, *x.shape[1:]), out)
    return dataclasses.replace(fs, bodies=bodies, fuel=fuel)


def _loglik(fs: FilterState, obs: torch.Tensor, params: EnvParams, cfg: PilotConfig
            ) -> torch.Tensor:
    """(N, P) log-likelihood of the presented observations (N, obs_dim)."""
    q_read, w_read, _, drift = _parse_obs(obs, params)
    q = fs.bodies.quat
    # q and -q are the same rotation
    dq = torch.minimum(torch.sum((q - q_read[:, None]) ** 2, -1),
                       torch.sum((q + q_read[:, None]) ** 2, -1))
    dw = torch.sum((fs.bodies.omega - w_read[:, None]) ** 2, -1)
    ll = -(dq + dw) / (2.0 * cfg.sigma_imu ** 2)
    if drift is not None:
        dd = torch.sum((_predicted_drift(fs.bodies, params) - drift[:, None]) ** 2, -1)
        ll = ll - dd / (2.0 * cfg.sigma_drift ** 2)
    return ll


def _prior_box(params: EnvParams, device):
    """The DR prior's support (the benchmark's public definition)."""
    rnd, rp = params.randomization, params.rocket
    cg, w = rnd.cg_offset_max, rnd.wind_max
    return ((rp.mass * (1.0 - rnd.mass_variation), rp.mass * (1.0 + rnd.mass_variation)),
            (1.0 - 2.0 * rnd.thrust_variation, 1.0 + 2.0 * rnd.thrust_variation),
            _constant((cg, cg, cg * 0.5), device), _constant((w, w, 0.0), device))


def systematic_indices(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Systematic resampling's particle indices (N, P) of normalized weights
    w (N, P) and offsets u (N,): the left ``searchsorted`` of (u + i) / P in
    the cumulative weights, clipped to P − 1."""
    p = w.shape[-1]
    cum = torch.cumsum(w, -1)
    pts = (u[:, None] + torch.arange(p, dtype=F32, device=w.device)) / p
    return torch.clamp(torch.searchsorted(cum, pts), 0, p - 1)


def _resample(fs: FilterState, params: EnvParams, cfg: PilotConfig,
              draws: ResampleDraws) -> FilterState:
    """Systematic resampling with Liu-West jitter where the effective sample
    size fell below ``ess_frac · P``, selected per env (the others keep
    their particles and normalized log weights)."""
    n, p = fs.log_w.shape
    lw = fs.log_w - torch.logsumexp(fs.log_w, -1, keepdim=True)
    w = torch.exp(lw)
    need = (1.0 / torch.sum(w ** 2, -1)) < cfg.ess_frac * p   # (N,)
    idx = systematic_indices(w, draws.u)

    def take(x):
        gathered = torch.take_along_dim(x, idx.view(n, p, *([1] * (x.dim() - 2))), dim=1)
        return torch.where(need.view(n, *([1] * (x.dim() - 1))), gathered, x)

    def wstd(x):
        wx = w.view(n, p, *([1] * (x.dim() - 2)))
        mu = torch.sum(wx * x, 1, keepdim=True)
        return torch.sqrt(torch.sum(wx * (x - mu) ** 2, 1) + 1e-12)

    bodies, dr = tree_map(take, fs.bodies), tree_map(take, fs.dr)
    n8 = draws.n_jit
    (m_lo, m_hi), (t_lo, t_hi), cg_hi, wind_hi = _prior_box(params, fs.log_w.device)
    j_m = n8[..., 0] * (cfg.jitter_frac * wstd(fs.dr.mass)[:, None] + cfg.jitter_floor_mass)
    j_t = n8[..., 1] * (cfg.jitter_frac * wstd(fs.dr.thrust_scale)[:, None]
                        + cfg.jitter_floor_thrust)
    j_cg = n8[..., 2:5] * (cfg.jitter_frac * wstd(fs.dr.cg_offset)[:, None]
                           + cfg.jitter_floor_cg)
    j_wind = n8[..., 5:8] * (cfg.jitter_frac * wstd(fs.dr.wind)[:, None] + cfg.jitter_floor_wind)
    j_wind = j_wind * _constant((1.0, 1.0, 0.0), j_wind.device)   # the wind is horizontal
    nd1, nd2 = need[:, None], need[:, None, None]
    dr = dataclasses.replace(
        dr,
        mass=torch.clamp(dr.mass + torch.where(nd1, j_m, 0.0), m_lo, m_hi),
        thrust_scale=torch.clamp(dr.thrust_scale + torch.where(nd1, j_t, 0.0), t_lo, t_hi),
        cg_offset=torch.clamp(dr.cg_offset + torch.where(nd2, j_cg, 0.0), -cg_hi, cg_hi),
        wind=torch.clamp(dr.wind + torch.where(nd2, j_wind, 0.0), -wind_hi, wind_hi),
    )
    return dataclasses.replace(fs, bodies=bodies, dr=dr,
                               log_w=torch.where(nd1, torch.zeros_like(lw), lw))


def _observer_correct(fs: FilterState, obs: torch.Tensor, params: EnvParams,
                      cfg: PilotConfig) -> FilterState:
    """Blend each particle's observed channels toward the presented reading."""
    q_read, w_read, _, drift = _parse_obs(obs, params)
    b = fs.bodies
    q_read, w_read = q_read[:, None], w_read[:, None]
    sgn = torch.sign(torch.sum(b.quat * q_read, -1, keepdim=True))
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    g = cfg.obs_gain_imu
    q = quat.normalize(b.quat + g * (sgn * q_read - b.quat))
    w = b.omega + g * (w_read - b.omega)
    pos, vel = b.pos, b.vel
    if drift is not None:
        gd = cfg.obs_gain_drift
        vel_read = drift[:, None, :2] / params.drift_obs_vel_scale
        pos_read = drift[:, None, 2:] / params.drift_obs_pos_scale
        vel = torch.cat([vel[..., :2] + gd * (vel_read - vel[..., :2]), vel[..., 2:]], -1)
        pos = torch.cat([pos[..., :2] + gd * (pos_read - pos[..., :2]), pos[..., 2:]], -1)
    return dataclasses.replace(fs, bodies=RigidBodyState(pos=pos, quat=q, vel=vel, omega=w))


def draw_resample(n: int, p: int, device, generator: torch.Generator | None) -> ResampleDraws:
    return ResampleDraws(u=torch.rand(n, device=device, generator=generator),
                         n_jit=torch.randn((n, p, 8), device=device, generator=generator))


def observe(fs: FilterState, action: torch.Tensor, obs: torch.Tensor, params: EnvParams,
            cfg: PilotConfig, draws: ResampleDraws | None = None,
            generator: torch.Generator | None = None) -> FilterState:
    """One filter cycle: predict under the applied action, weight, observer
    feedback, resample if degenerate."""
    fs = _predict(fs, action, params)
    fs = dataclasses.replace(fs, log_w=fs.log_w + _loglik(fs, obs, params, cfg))
    fs = _observer_correct(fs, obs, params, cfg)
    if draws is None:
        draws = draw_resample(*fs.log_w.shape, fs.log_w.device, generator)
    return _resample(fs, params, cfg, draws)


def _weights(fs: FilterState) -> torch.Tensor:
    return torch.softmax(fs.log_w, -1)


def estimate_body(fs: FilterState) -> RigidBodyState:
    """Posterior-mean bodies (N, ...): quaternions sign-aligned to each
    swarm's highest-weight particle, averaged and renormalized."""
    w = _weights(fs)
    n = w.shape[0]

    def wm(x):
        return torch.sum(w[..., None] * x, 1)

    ref = fs.bodies.quat[torch.arange(n, device=w.device), torch.argmax(w, -1)]
    sgn = torch.sign(torch.sum(fs.bodies.quat * ref[:, None], -1, keepdim=True))
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    return RigidBodyState(pos=wm(fs.bodies.pos), quat=quat.normalize(wm(fs.bodies.quat * sgn)),
                          vel=wm(fs.bodies.vel), omega=wm(fs.bodies.omega))


def estimate_dr(fs: FilterState) -> DomainParams:
    """Posterior-mean draws (N, ...)."""
    w = _weights(fs)
    return tree_map(lambda x: torch.sum(w.view(*w.shape, *([1] * (x.dim() - 2))) * x, 1), fs.dr)


def init_pilot(obs0: torch.Tensor, params: EnvParams, cfg: PilotConfig,
               u_dr: torch.Tensor | None = None, n_dr: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> PilotState:
    n, dev = obs0.shape[0], obs0.device
    return PilotState(filt=init_filter(obs0, params, cfg, u_dr, n_dr, generator),
                      theta=torch.zeros((n, cem_mod.THETA_DIM), dtype=F32, device=dev),
                      has_theta=torch.zeros(n, dtype=torch.bool, device=dev),
                      prev_action=torch.zeros((n, ACTION_DIM), dtype=F32, device=dev),
                      last_obs=obs0)


def body_from_obs(obs: torch.Tensor, filt: FilterState, params: EnvParams) -> RigidBodyState:
    """The control state straight from the observations: quat/ω the IMU
    reading, xy pos/vel the INS drift channels, (z, vz) the posterior mean."""
    q_read, w_read, _, drift = _parse_obs(obs, params)
    post = estimate_body(filt)
    if drift is not None:
        vel_xy = drift[:, :2] / params.drift_obs_vel_scale
        pos_xy = drift[:, 2:] / params.drift_obs_pos_scale
    else:
        vel_xy, pos_xy = post.vel[:, :2], post.pos[:, :2]
    return RigidBodyState(pos=torch.cat([pos_xy, post.pos[:, 2:3]], -1),
                          quat=quat.normalize(q_read),
                          vel=torch.cat([vel_xy, post.vel[:, 2:3]], -1), omega=w_read)


def control_body(ps: PilotState, params: EnvParams, cfg: PilotConfig) -> RigidBodyState:
    """The state the control law sees (``PilotConfig.state_from_obs``)."""
    if cfg.state_from_obs:
        return body_from_obs(ps.last_obs, ps.filt, params)
    return estimate_body(ps.filt)


@torch.no_grad()
def pilot_act(ps: PilotState, sched: demos.LQRSchedule, params: EnvParams,
              cfg: PilotConfig = PilotConfig()) -> tuple[PilotState, torch.Tensor]:
    """Actions (N, 2) from the posterior: the committed controller once there
    is one, else the gain-scheduled blind LQR at the posterior-mean plant."""
    body = control_body(ps, params, cfg)
    dr = estimate_dr(ps.filt)
    rp = params.rocket
    a_lqr = demos.lqr_action_scheduled(body, sched, dr.mass, dr.thrust_scale,
                                       torch.zeros_like(body.pos), rp)
    a_cem = cem_mod.controller_action(ps.theta, body, rp)
    action = torch.where(ps.has_theta[:, None], a_cem, a_lqr)
    return dataclasses.replace(ps, prev_action=action), action


@torch.no_grad()
def pilot_observe(ps: PilotState, obs: torch.Tensor, params: EnvParams, cfg: PilotConfig,
                  draws: ResampleDraws | None = None,
                  generator: torch.Generator | None = None) -> PilotState:
    return dataclasses.replace(
        ps, filt=observe(ps.filt, ps.prev_action, obs, params, cfg, draws, generator),
        last_obs=obs)


def _hypothesis_states(template: EnvState, bodies: RigidBodyState, drs: DomainParams,
                       fuel: torch.Tensor, prev_action: torch.Tensor) -> EnvState:
    """``template`` (shapes only) holding the given hypotheses at a fresh
    episode's counters."""
    n, dev = fuel.shape[0], fuel.device
    zeros_i = torch.zeros(n, dtype=torch.int32, device=dev)
    return dataclasses.replace(template, body=bodies, dr=drs, fuel=fuel, step_count=zeros_i,
                               mission_success=torch.zeros(n, dtype=torch.bool, device=dev),
                               success_count=zeros_i.clone(), prev_action=prev_action)


def replan_from(ps: PilotState, bodies: RigidBodyState, drs: DomainParams, fuel: torch.Tensor,
                sched: demos.LQRSchedule, params: EnvParams, ccfg: cem_mod.CEMConfig,
                template: EnvState, draws: cem_mod.CEMDraws | None = None,
                generator: torch.Generator | None = None) -> PilotState:
    """A per-draw CEM replan from explicit (body, draw, fuel) hypotheses (N),
    warm-started from the previous plan where there is one."""
    states = _hypothesis_states(template, bodies, drs, fuel, ps.prev_action)
    theta0 = cem_mod.theta_from_design(demos.interp_design(sched, drs.mass, drs.thrust_scale))
    theta0 = torch.where(ps.has_theta[:, None], ps.theta, theta0)
    theta, _ = cem_mod.refine_per_draw(params, states, theta0, ccfg, draws=draws,
                                       generator=generator)
    return dataclasses.replace(ps, theta=theta, has_theta=torch.ones_like(ps.has_theta))


def replan(ps: PilotState, sched: demos.LQRSchedule, params: EnvParams,
           ccfg: cem_mod.CEMConfig, template: EnvState, draws: cem_mod.CEMDraws | None = None,
           generator: torch.Generator | None = None) -> PilotState:
    """A CEM replan inside the pilot's model, from the posterior-mean state on
    the posterior-mean plant."""
    return replan_from(ps, estimate_body(ps.filt), estimate_dr(ps.filt), ps.filt.fuel, sched,
                       params, ccfg, template, draws, generator)


def draw_gumbel(shape, device, generator: torch.Generator | None) -> torch.Tensor:
    """Standard Gumbel draws −log(−log(u)), u in [tiny, 1)."""
    u = torch.rand(shape, device=device, generator=generator)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(F32).tiny)))


@torch.no_grad()
def select_from_library(
    ps: PilotState,
    library: torch.Tensor,
    params: EnvParams,
    score_cfg: cem_mod.CEMConfig,
    template: EnvState,
    n_samples: int = 8,
    bodies: RigidBodyState | None = None,
    drs: DomainParams | None = None,
    fuel: torch.Tensor | None = None,
    gumbel: torch.Tensor | None = None,
    obs_noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> PilotState:
    """Score every library member (K, 15) on ``n_samples`` posterior
    particles per env inside the pilot's model (N·S·K rollouts of
    ``score_cfg.horizon`` steps: env slowest, sample middle, member fastest)
    and commit each env to the member with the best mean score. The
    particles are ``categorical(log_w)`` draws, the argmax of the log
    weights plus ``gumbel`` (N, S, P). ``bodies``/``drs``/``fuel`` are the
    privileged probes' overrides (the episode's truth, tiled over the
    samples)."""
    n, s, k = ps.has_theta.shape[0], n_samples, library.shape[0]
    log_w = ps.filt.log_w
    if gumbel is None:
        gumbel = draw_gumbel((n, s, log_w.shape[1]), log_w.device, generator)
    idx = torch.argmax(log_w[:, None, :] + gumbel, dim=-1)   # (N, S)

    def take(x):
        return torch.take_along_dim(x, idx.view(n, s, *([1] * (x.dim() - 2))), dim=1)

    def tile(x):
        return x[:, None].expand(n, s, *x.shape[1:])

    def rep(x):
        return torch.repeat_interleave(x.reshape(n * s, *x.shape[2:]), k, dim=0)

    bodies = tree_map(take, ps.filt.bodies) if bodies is None else tree_map(tile, bodies)
    drs = tree_map(take, ps.filt.dr) if drs is None else tree_map(tile, drs)
    fuel_src = ps.filt.fuel if fuel is None else fuel
    states = _hypothesis_states(
        tree_map(lambda x: torch.repeat_interleave(x, s * k, dim=0), template),
        tree_map(rep, bodies), tree_map(rep, drs),
        torch.repeat_interleave(fuel_src, s * k), torch.repeat_interleave(ps.prev_action, s * k,
                                                                          dim=0))
    theta = library.repeat(n * s, 1)
    scores = cem_mod.rollout_score(theta, states, params, score_cfg, obs_noise=obs_noise,
                                   generator=generator)
    best = torch.argmax(scores.reshape(n, s, k).mean(1), dim=1)
    return dataclasses.replace(ps, theta=library[best], has_theta=torch.ones_like(ps.has_theta))

