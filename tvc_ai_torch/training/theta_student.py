"""θ-student: identify the episode's controller instead of imitating its actions.

Counterpart of ``tvc_ai_tpu/training/theta_student.py`` (its docstring gives
the measurements behind it). The per-draw CEM teacher is a linear
ground-balance controller whose 10 components the student's observation can
express (``STUDENT_THETA_IDX``) are constant within an episode; the student
``ThetaNet`` regresses those 10 numbers from the stacked (obs, action)
history, and the action follows analytically from them and the newest frame
(``theta_hat_action``).

``make_theta_dagger_iteration`` has the CEM-teacher DAgger shape of
``training.dagger`` (fresh draws, a student-view-masked CEM solve per draw,
draw recycling, one β-mixed frozen episode per env through
``rocket_env.batched_step_autoreset``, K1 on the card) with the episode's
constant θ as every row's label and a per-component scaled MSE. Draws are
explicit (``dagger.DaggerDraws``) or come from ``generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
from torch import nn

from tvc_ai_torch.agents import optim
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.types import EnvParams
from tvc_ai_torch.eval.rollout import _freeze
from tvc_ai_torch.physics import quaternion as quat
from tvc_ai_torch.training import cem as cem_mod
from tvc_ai_torch.training import demos
from tvc_ai_torch.training.dagger import DaggerDraws, _mix, _step_draws, draw_and_recycle
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device

F32 = torch.float32
# the free components of the CEM θ layout: yaw-plane gains on [x, tilt_x,
# vx, ω_y], pitch-plane gains on [y, tilt_y, vy, ω_x], the two trims (the
# dz/vz columns 1, 4, 7, 10 and z_eq 14 are left out: no altitude channel)
STUDENT_THETA_IDX = (0, 2, 3, 5, 6, 8, 9, 11, 12, 13)
STUDENT_THETA_DIM = len(STUDENT_THETA_IDX)


def student_view_mask(device: str | torch.device = "cpu") -> torch.Tensor:
    """(15,) mask zeroing the θ components the student cannot express."""
    mask = torch.zeros(cem_mod.THETA_DIM, dtype=F32, device=device)
    mask[list(STUDENT_THETA_IDX)] = 1.0
    return mask


def pack_student_theta(theta_full: torch.Tensor) -> torch.Tensor:
    """(…, 15) θ → its (…, 10) student components."""
    return theta_full[..., list(STUDENT_THETA_IDX)]


def unpack_student_theta(theta10: torch.Tensor) -> torch.Tensor:
    """(…, 10) student components → (…, 15) θ with zeros elsewhere."""
    out = torch.zeros(theta10.shape[:-1] + (cem_mod.THETA_DIM,), dtype=theta10.dtype,
                      device=theta10.device)
    out[..., list(STUDENT_THETA_IDX)] = theta10
    return out


def theta_scale(sched: demos.LQRSchedule) -> torch.Tensor:
    """(10,) regression scales from the schedule's own spread: the grid's
    standard deviation (ddof 0) plus a quarter of its mean magnitude, at
    least 0.05."""
    grid = demos.LQRDesign(gain=sched.gain.reshape(-1, 6),
                           gain_pitch=sched.gain_pitch.reshape(-1, 6),
                           z_eq=sched.z_eq.reshape(-1), trim_slope=sched.trim_slope.reshape(-1),
                           trim_slope_pitch=sched.trim_slope_pitch.reshape(-1))
    t10 = pack_student_theta(cem_mod.theta_from_design(grid))
    spread = t10.std(0, correction=0) + 0.25 * t10.abs().mean(0)
    return torch.clamp(spread, min=0.05)


def theta_hat_action(theta10: torch.Tensor, frame: torch.Tensor, params: EnvParams
                     ) -> torch.Tensor:
    """The analytic action of θ̂ (…, 10) on the newest observation frame:
    ``cem.controller_action``'s form on the presented readings. The frame is
    [quat(4), ω(3), fuel, phase, progress, vx·s, vy·s, x·s, y·s, a_prev(2)]
    (drift and action channels on, trim channels off)."""
    if not (params.drift_obs_enabled and params.action_obs_enabled):
        raise AssertionError("theta-student requires the drift and action observation channels")
    if params.trim_obs_enabled:
        raise AssertionError("frame layout here assumes trim channels are off")
    up = torch.zeros(frame.shape[:-1] + (3,), dtype=frame.dtype, device=frame.device)
    up[..., 2] = 1.0
    zhat = quat.rotate(frame[..., 0:4], up)
    tilt_x = torch.atan2(zhat[..., 0], zhat[..., 2])
    tilt_y = torch.atan2(-zhat[..., 1], zhat[..., 2])
    wx, wy = frame[..., 4], frame[..., 5]
    vx = frame[..., 10] / params.drift_obs_vel_scale
    vy = frame[..., 11] / params.drift_obs_vel_scale
    x = frame[..., 12] / params.drift_obs_pos_scale
    y = frame[..., 13] / params.drift_obs_pos_scale
    u_yaw = -(theta10[..., 0] * x + theta10[..., 1] * tilt_x + theta10[..., 2] * vx
              + theta10[..., 3] * wy)
    u_pitch = -(theta10[..., 4] * y + theta10[..., 5] * tilt_y + theta10[..., 6] * vy
                + theta10[..., 7] * wx)
    act = torch.stack([u_pitch, u_yaw], dim=-1) / params.rocket.max_gimbal
    return torch.clamp(act + theta10[..., 8:10], -1.0, 1.0)


class ThetaNet(nn.Module):
    """View → θ̂: a ReLU MLP and a linear head. The submodules are named as
    flax names them (``Dense_0``, …, the head last), so
    ``convert.theta_net_from_flax`` maps a flax θ-net one to one. Seeded
    initialization (flax's: LeCun-normal kernels, zero biases) on the CPU."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int] = (256, 256),
                 out_dim: int = STUDENT_THETA_DIM,
                 device: str | torch.device = DEFAULT_DEVICE, seed: int = 0):
        super().__init__()
        gen = torch.Generator().manual_seed(seed)
        self.hidden_dims = tuple(hidden_dims)
        width = in_dim
        for i, h in enumerate((*self.hidden_dims, out_dim)):
            layer = nn.Linear(width, h)
            with torch.no_grad():
                layer.weight.normal_(0.0, 1.0, generator=gen).mul_(width ** -0.5)
                layer.bias.zero_()
            self.add_module(f"Dense_{i}", layer)
            width = h
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.hidden_dims)
        for i in range(n):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{n}")(x)


@dataclasses.dataclass(frozen=True)
class ThetaDaggerConfig:
    num_envs: int = 512
    rollout_steps: int = 512
    capacity: int = 1 << 21
    batch_size: int = 4096
    train_steps: int = 1500
    lr: float = 3e-4
    history_len: int = 8
    hidden_dims: tuple = (256, 256)


@dataclasses.dataclass
class ThetaDaggerState:
    net: ThetaNet
    opt: optim.AdamState
    data_obs: torch.Tensor     # (capacity, view_dim)
    data_theta: torch.Tensor   # (capacity, 10)
    data_w: torch.Tensor       # (capacity,)
    ptr: int
    size: int


def init_theta_state(cfg: ThetaDaggerConfig, obs_dim: int,
                     device: str | torch.device = DEFAULT_DEVICE, seed: int = 0,
                     net: ThetaNet | None = None) -> ThetaDaggerState:
    """A seeded ``ThetaNet`` (or ``net``), a fresh Adam state, a zero ring."""
    dev = resolve_device(device)
    if cfg.capacity % (cfg.num_envs * cfg.rollout_steps):
        raise AssertionError("capacity must be a multiple of rollout rows so ring writes never "
                             "straddle the wrap")
    view_dim = obs_dim * cfg.history_len
    net = net if net is not None else ThetaNet(view_dim, cfg.hidden_dims, device=dev, seed=seed)
    return ThetaDaggerState(
        net=net, opt=optim.adam_init(list(net.parameters())),
        data_obs=torch.zeros((cfg.capacity, view_dim), dtype=F32, device=dev),
        data_theta=torch.zeros((cfg.capacity, STUDENT_THETA_DIM), dtype=F32, device=dev),
        data_w=torch.zeros((cfg.capacity,), dtype=F32, device=dev), ptr=0, size=0)


def make_theta_dagger_iteration(
    env_params: EnvParams,
    sched: demos.LQRSchedule,
    cfg: ThetaDaggerConfig,
    obs_dim: int,
    cem_cfg: cem_mod.CEMConfig = cem_mod.CEMConfig(),
    lr_fn: Callable[[int], float] | None = None,
):
    """``iteration(state, beta, draws=None, generator=None) -> (state,
    metrics)``: the CEM-teacher DAgger step with the episode's constant θ
    (10 student components) as the label and the scaled MSE
    Σ((θ̂ − θ)/scale)², weighted. The state changes in place."""
    del obs_dim
    lr_fn = lr_fn or (lambda count: cfg.lr)
    n, steps, hist = cfg.num_envs, cfg.rollout_steps, cfg.history_len
    n_rows = n * steps
    rp = env_params.rocket
    scale_cpu = theta_scale(sched)

    @torch.no_grad()
    def collect(state: ThetaDaggerState, beta: float, draws, generator):
        dev = state.data_obs.device
        env_states, obs, theta, solved, teacher_ok = draw_and_recycle(
            env_params, sched.to(dev), cem_cfg, n, dev, draws, generator,
            theta_mask=student_view_mask(dev))
        label10 = pack_student_theta(theta)
        window = obs[:, None, :].repeat(1, hist, 1)
        done = torch.zeros(n, dtype=torch.bool, device=dev)
        successes = torch.zeros((), dtype=torch.int64, device=dev)
        labeled = torch.zeros((), dtype=F32, device=dev)
        for t in range(steps):
            view = window.reshape(n, -1)
            teacher_act = cem_mod.controller_action(theta, env_states.body, rp)
            student_act = theta_hat_action(state.net(view), obs, env_params)
            action = torch.where(_mix(draws, t, n, dev, generator) < beta, teacher_act,
                                 student_act)
            d = _step_draws(draws, t)
            nxt, out, next_obs = rocket_env.batched_step_autoreset(
                env_states, action, env_params, generator=generator, n_imu=d.n_imu,
                reset_draws=d.reset, u_drop=d.u_drop)
            ep_done = out.terminated | out.truncated
            env_states = _freeze(done, nxt, env_states)
            next_obs = torch.where(done[:, None], obs, next_obs)
            shifted = torch.cat([window[:, 1:], next_obs[:, None, :]], dim=1)
            window = torch.where(done[:, None, None], window, shifted)
            weight = teacher_ok * (1.0 - done.to(F32))
            successes += (~done & ep_done & out.mission_success).sum()
            labeled += weight.sum()
            row = state.ptr + t * n
            state.data_obs[row:row + n] = view
            state.data_theta[row:row + n] = label10
            state.data_w[row:row + n] = weight
            obs = next_obs
            done = done | ep_done
        state.ptr = (state.ptr + n_rows) % cfg.capacity
        state.size = min(state.size + n_rows, cfg.capacity)
        return {"teacher_solved": solved.to(F32).mean(), "rollout_episodes": done.sum(),
                "rollout_success": successes, "labeled_rows": labeled}

    def train(state: ThetaDaggerState, draws: DaggerDraws | None = None,
              generator: torch.Generator | None = None):
        idx = None if draws is None else draws.idx
        params = list(state.net.parameters())
        dev = state.data_obs.device
        scale = scale_cpu.to(dev)
        losses = []
        for i in range(cfg.train_steps):
            rows = (idx[i] if idx is not None else
                    torch.randint(0, max(state.size, 1), (cfg.batch_size,), device=dev,
                                  generator=generator))
            ob, la, w = state.data_obs[rows], state.data_theta[rows], state.data_w[rows]
            err = torch.sum(((state.net(ob) - la) / scale) ** 2, dim=-1)
            loss = torch.sum(w * err) / torch.clamp(torch.sum(w), min=1.0)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                optim.adam_step(params, grads, state.opt, lr_fn(state.opt.count))
            if i == 0 or i == cfg.train_steps - 1:
                losses.append(loss.detach())
        return {"theta_loss_first": losses[0], "theta_loss_last": losses[-1]}

    def iteration(state: ThetaDaggerState, beta: float, draws: DaggerDraws | None = None,
                  generator: torch.Generator | None = None):
        roll = collect(state, beta, draws, generator)
        return state, {**roll, **train(state, draws, generator)}

    iteration.collect, iteration.train = collect, train   # the two halves, to time them alone
    return iteration


def make_theta_policy_fn(env_params: EnvParams, cfg: ThetaDaggerConfig):
    """The deployable policy ``(net, view) -> action`` for
    ``eval.rollout.make_policy_eval_fn``: θ̂ from the stacked view, the
    analytic controller on its newest frame."""

    @torch.no_grad()
    def policy_fn(net: ThetaNet, view: torch.Tensor) -> torch.Tensor:
        obs_dim = view.shape[-1] // cfg.history_len
        return theta_hat_action(net(view), view[..., -obs_dim:], env_params)

    return policy_fn
