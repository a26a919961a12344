"""DAgger distillation: a privileged teacher labels a blind student's states.

Counterpart of ``tvc_ai_tpu/training/dagger.py`` (its docstring gives the
measurements behind the design). The student is the SAC ``GaussianActor``
over a stacked (obs, action) history window; its loss regresses
``tanh(mean(view))`` onto the teacher's action. Two teachers:

- ``make_dagger_iteration``: any ``teacher_fn(env_states)`` (the
  gain-scheduled LQR reading each episode's true mass and thrust draw) on
  persistent autoreset envs;
- ``make_cem_dagger_iteration``: each iteration draws fresh envs, CEM-solves
  a controller per draw (``training.cem``), lends a solved draw's plant and
  controller to the envs whose draw the teacher failed, and rolls one frozen
  episode per env; rows after an episode's end, or from an iteration where
  no draw was solved, have weight 0 (``data_w``).

Each iteration records ``rollout_steps × num_envs`` (view, label) rows into a
device-resident ring (allocated once; the write never straddles the wrap)
and takes ``train_steps`` Adam minibatches (``agents.optim``, optionally on
a learning-rate schedule) on it. The student acts, the env steps through
``rocket_env.batched_step_autoreset`` (K1 on the card; the reference steps
the plain integrator) and the ring fills step by step: the iteration reads
nothing from the device but returns its metrics as device tensors. ``ptr``
and ``size`` are host ints.

Randomness is explicit (``DaggerDraws``) or comes from
``generator``: the β mixing draw (teacher drives where ``u_mix < β``), each
step's env draws, the CEM's noise, the recycling draw (the reference's
``choice`` by weight: ``searchsorted(cumsum(p), p_total · (1 − u))``) and
the minibatch rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from tvc_ai_torch.agents import optim
from tvc_ai_torch.agents import sac as sac_mod
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.rocket_env import ResetDraws
from tvc_ai_torch.env.types import EnvParams, EnvState
from tvc_ai_torch.eval.rollout import _freeze
from tvc_ai_torch.models.mlp import GaussianActor
from tvc_ai_torch.training import cem as cem_mod
from tvc_ai_torch.training import demos
from tvc_ai_torch.training.loop import StepDraws
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device
from tvc_ai_torch.utils.tree import tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class DaggerConfig:
    num_envs: int = 512
    rollout_steps: int = 512          # env steps recorded per iteration
    capacity: int = 1 << 20           # aggregate ring dataset (rows)
    batch_size: int = 4096
    train_steps: int = 1500           # Adam minibatches per iteration
    lr: float = 3e-4
    history_len: int = 1


@dataclasses.dataclass
class DaggerState:
    actor: GaussianActor
    opt: optim.AdamState
    data_obs: torch.Tensor      # (capacity, view_dim)
    data_act: torch.Tensor      # (capacity, act_dim)
    ptr: int                    # ring write pointer
    size: int                   # valid rows
    env_states: EnvState
    obs: torch.Tensor           # (num_envs, obs_dim) current observation
    window: torch.Tensor | None  # (num_envs, history, obs_dim) when history > 1


@dataclasses.dataclass
class CemDaggerState:
    """The ring and the student of the CEM-teacher variant (no persistent
    envs: every iteration draws a fresh batch)."""

    actor: GaussianActor
    opt: optim.AdamState
    data_obs: torch.Tensor      # (capacity, view_dim)
    data_act: torch.Tensor      # (capacity, act_dim)
    data_w: torch.Tensor        # (capacity,) label weight (0: no label)
    ptr: int
    size: int


@dataclasses.dataclass
class DaggerDraws:
    """One iteration's draws: ``u_mix`` (T, N, 1) U[0, 1) (the teacher drives
    where below β), each step's env draws (``StepDraws``: IMU noise,
    dropout, the autoreset's), the minibatch rows ``idx`` (train_steps, B);
    the CEM variant adds the fresh envs' reset draws, the CEM's draws and
    the recycling draw ``u_choice`` (N,) U[0, 1)."""

    u_mix: torch.Tensor | None = None
    steps: Sequence[StepDraws] | None = None
    idx: torch.Tensor | None = None
    reset: ResetDraws | None = None
    cem: cem_mod.CEMDraws | None = None
    u_choice: torch.Tensor | None = None


def _ring(cfg, view_dim: int, act_dim: int, dev: torch.device, weighted: bool):
    n_rows = cfg.num_envs * cfg.rollout_steps
    if cfg.capacity % n_rows:
        raise AssertionError("capacity must be a multiple of rollout rows so ring writes never "
                             "straddle the wrap")
    out = {"data_obs": torch.zeros((cfg.capacity, view_dim), dtype=F32, device=dev),
           "data_act": torch.zeros((cfg.capacity, act_dim), dtype=F32, device=dev)}
    if weighted:
        out["data_w"] = torch.zeros((cfg.capacity,), dtype=F32, device=dev)
    return out


def init_state(env_params: EnvParams, actor: GaussianActor, cfg: DaggerConfig, obs_dim: int,
               act_dim: int, device: str | torch.device = DEFAULT_DEVICE,
               generator: torch.Generator | None = None,
               reset_draws: ResetDraws | None = None) -> DaggerState:
    """The scheduled-teacher state: ``num_envs`` fresh envs, a zero ring of
    ``capacity`` rows, a fresh Adam state for ``actor``."""
    dev = resolve_device(device)
    states, obs = rocket_env.reset(env_params, cfg.num_envs, dev, generator=generator,
                                   draws=reset_draws)
    window = obs[:, None, :].repeat(1, cfg.history_len, 1) if cfg.history_len > 1 else None
    return DaggerState(actor=actor, opt=optim.adam_init(list(actor.parameters())),
                       **_ring(cfg, obs_dim * cfg.history_len, act_dim, dev, False),
                       ptr=0, size=0, env_states=states, obs=obs, window=window)


def init_cem_state(actor: GaussianActor, cfg: DaggerConfig, obs_dim: int, act_dim: int,
                   device: str | torch.device = DEFAULT_DEVICE) -> CemDaggerState:
    """The CEM-teacher state: a zero ring and a fresh Adam state."""
    dev = resolve_device(device)
    return CemDaggerState(actor=actor, opt=optim.adam_init(list(actor.parameters())),
                          **_ring(cfg, obs_dim * cfg.history_len, act_dim, dev, True),
                          ptr=0, size=0)


def _constant(lr: float) -> Callable[[int], float]:
    return lambda count: lr


def _train(state, cfg, lr_fn: Callable[[int], float], idx: torch.Tensor | None,
           generator: torch.Generator | None, weighted: bool) -> dict[str, torch.Tensor]:
    """``train_steps`` Adam minibatches on the ring, in place; the first and
    the last loss."""
    params = list(state.actor.parameters())
    dev = state.data_obs.device
    losses = []
    for i in range(cfg.train_steps):
        rows = (idx[i] if idx is not None else
                torch.randint(0, max(state.size, 1), (cfg.batch_size,), device=dev,
                              generator=generator))
        ob, la = state.data_obs[rows], state.data_act[rows]
        mean, _ = state.actor(ob)
        if weighted:
            w = state.data_w[rows]
            err = torch.sum((torch.tanh(mean) - la) ** 2, dim=-1)
            loss = torch.sum(w * err) / torch.clamp(torch.sum(w), min=1.0)
        else:
            loss = torch.mean((torch.tanh(mean) - la) ** 2)
        # the log-std head takes no part: zero gradients, as in the reference
        grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
        with torch.no_grad():
            optim.adam_step(params, grads, state.opt, lr_fn(state.opt.count))
        if i == 0 or i == cfg.train_steps - 1:
            losses.append(loss.detach())
    return {"bc_loss_first": losses[0], "bc_loss_last": losses[-1]}


def _mix(draws: DaggerDraws | None, t: int, n: int, dev, generator) -> torch.Tensor:
    if draws is not None and draws.u_mix is not None:
        return draws.u_mix[t]
    return torch.rand((n, 1), device=dev, generator=generator)


def _step_draws(draws: DaggerDraws | None, t: int) -> StepDraws:
    if draws is not None and draws.steps is not None:
        return draws.steps[t]
    return StepDraws()


def make_dagger_iteration(
    env_params: EnvParams,
    teacher_fn: Callable[[EnvState], torch.Tensor],
    sac_cfg: sac_mod.SACConfig,
    cfg: DaggerConfig,
    obs_dim: int,
    act_dim: int,
    lr_fn: Callable[[int], float] | None = None,
):
    """``iteration(state, beta, draws=None, generator=None) -> (state,
    metrics)`` with the teacher ``teacher_fn`` (env states → actions in [-1,
    1]); β is the per env-step probability that the teacher's action drives
    the env. ``lr_fn`` maps the Adam count to the learning rate (default the
    constant ``cfg.lr``). The state changes in place."""
    del sac_cfg, obs_dim, act_dim   # the student module carries its widths
    lr_fn = lr_fn or _constant(cfg.lr)
    n, steps = cfg.num_envs, cfg.rollout_steps
    n_rows = n * steps

    @torch.no_grad()
    def collect(state: DaggerState, beta: float, draws, generator):
        dev = state.obs.device
        episodes = torch.zeros((), dtype=torch.int64, device=dev)
        successes = torch.zeros((), dtype=torch.int64, device=dev)
        env_states, obs, window = state.env_states, state.obs, state.window
        for t in range(steps):
            view = window.reshape(n, -1) if window is not None else obs
            label = teacher_fn(env_states)
            mean, _ = state.actor(view)
            action = torch.where(_mix(draws, t, n, dev, generator) < beta, label,
                                 torch.tanh(mean))
            d = _step_draws(draws, t)
            env_states, out, next_obs = rocket_env.batched_step_autoreset(
                env_states, action, env_params, generator=generator, n_imu=d.n_imu,
                reset_draws=d.reset, u_drop=d.u_drop)
            done = out.terminated | out.truncated
            if window is not None:
                shifted = torch.cat([window[:, 1:], out.obs[:, None, :]], dim=1)
                fresh = next_obs[:, None, :].expand(-1, cfg.history_len, -1)
                window = torch.where(done[:, None, None], fresh, shifted)
            row = state.ptr + t * n
            state.data_obs[row:row + n] = view
            state.data_act[row:row + n] = label
            episodes += done.sum()
            successes += (done & out.mission_success).sum()
            obs = next_obs
        state.env_states, state.obs, state.window = env_states, obs, window
        state.ptr = (state.ptr + n_rows) % cfg.capacity
        state.size = min(state.size + n_rows, cfg.capacity)
        return {"rollout_episodes": episodes, "rollout_success": successes}

    def train(state: DaggerState, draws: DaggerDraws | None = None,
              generator: torch.Generator | None = None):
        return _train(state, cfg, lr_fn, None if draws is None else draws.idx, generator,
                      weighted=False)

    def iteration(state: DaggerState, beta: float, draws: DaggerDraws | None = None,
                  generator: torch.Generator | None = None):
        roll = collect(state, beta, draws, generator)
        return state, {**roll, **train(state, draws, generator)}

    iteration.collect, iteration.train = collect, train   # the two halves, to time them alone
    return iteration


def draw_and_recycle(env_params: EnvParams, sched: demos.LQRSchedule, cem_cfg: cem_mod.CEMConfig,
                     num_envs: int, dev: torch.device, draws: DaggerDraws | None,
                     generator: torch.Generator | None,
                     theta_mask: torch.Tensor | None = None):
    """The CEM teacher's start of an iteration, shared with the θ-student:
    fresh envs, a CEM solve per draw from the schedule's θ, and draw
    recycling (envs whose draw was not solved borrow a solved env's plant
    and controller, drawn by weight). Returns (states0, obs0, θ, solved,
    teacher_ok) with teacher_ok 1 everywhere if any draw was solved, else 0."""
    states0, obs0 = rocket_env.reset(env_params, num_envs, dev, generator=generator,
                                     draws=None if draws is None else draws.reset)
    theta0 = cem_mod.theta_for_states(sched, states0)
    theta, score = cem_mod.refine_per_draw(
        env_params, states0, theta0, cem_cfg, theta_mask=theta_mask,
        draws=None if draws is None else draws.cem, generator=generator)
    solved = score >= 0.5 * cem_cfg.success_bonus
    any_solved = solved.any()
    p = solved.to(F32)
    p = torch.where(any_solved, p / torch.clamp(p.sum(), min=1.0),
                    torch.full_like(p, 1.0 / num_envs))
    cum = torch.cumsum(p, 0)
    u = (draws.u_choice if draws is not None and draws.u_choice is not None
         else torch.rand(num_envs, device=dev, generator=generator))
    src = torch.clamp(torch.searchsorted(cum, cum[-1] * (1.0 - u)), max=num_envs - 1)

    def borrow(arr):
        keep = solved.view(-1, *([1] * (arr.dim() - 1)))
        return torch.where(keep, arr, arr[src])

    states0.dr = tree_map(borrow, states0.dr)
    teacher_ok = torch.where(any_solved, 1.0, 0.0).expand(num_envs)
    return states0, obs0, borrow(theta), solved, teacher_ok


def make_cem_dagger_iteration(
    env_params: EnvParams,
    sched: demos.LQRSchedule,
    sac_cfg: sac_mod.SACConfig,
    cfg: DaggerConfig,
    obs_dim: int,
    act_dim: int,
    cem_cfg: cem_mod.CEMConfig = cem_mod.CEMConfig(),
    lr_fn: Callable[[int], float] | None = None,
):
    """The CEM-teacher ``iteration(state, beta, draws=None, generator=None)
    -> (state, metrics)``: fresh draws, a CEM solve per draw, draw
    recycling, one β-mixed frozen episode per env labelled with the draw's
    controller, weighted BC on the ring (rows after an episode's end weigh
    0). The state changes in place."""
    del sac_cfg, obs_dim, act_dim
    lr_fn = lr_fn or _constant(cfg.lr)
    n, steps, hist = cfg.num_envs, cfg.rollout_steps, cfg.history_len
    n_rows = n * steps
    rp = env_params.rocket

    @torch.no_grad()
    def collect(state: CemDaggerState, beta: float, draws, generator):
        dev = state.data_obs.device
        sched_d = sched.to(dev)
        env_states, obs, theta, solved, teacher_ok = draw_and_recycle(
            env_params, sched_d, cem_cfg, n, dev, draws, generator)
        window = obs[:, None, :].repeat(1, hist, 1) if hist > 1 else None
        done = torch.zeros(n, dtype=torch.bool, device=dev)
        successes = torch.zeros((), dtype=torch.int64, device=dev)
        labeled = torch.zeros((), dtype=F32, device=dev)
        for t in range(steps):
            view = window.reshape(n, -1) if window is not None else obs
            label = cem_mod.controller_action(theta, env_states.body, rp)
            mean, _ = state.actor(view)
            action = torch.where(_mix(draws, t, n, dev, generator) < beta, label,
                                 torch.tanh(mean))
            d = _step_draws(draws, t)
            nxt, out, next_obs = rocket_env.batched_step_autoreset(
                env_states, action, env_params, generator=generator, n_imu=d.n_imu,
                reset_draws=d.reset, u_drop=d.u_drop)
            ep_done = out.terminated | out.truncated
            # a finished episode stays frozen: its autoreset is a new draw
            env_states = _freeze(done, nxt, env_states)
            next_obs = torch.where(done[:, None], obs, next_obs)
            if window is not None:
                shifted = torch.cat([window[:, 1:], next_obs[:, None, :]], dim=1)
                window = torch.where(done[:, None, None], window, shifted)
            weight = teacher_ok * (1.0 - done.to(F32))
            successes += (~done & ep_done & out.mission_success).sum()
            labeled += weight.sum()
            row = state.ptr + t * n
            state.data_obs[row:row + n] = view
            state.data_act[row:row + n] = label
            state.data_w[row:row + n] = weight
            obs = next_obs
            done = done | ep_done
        state.ptr = (state.ptr + n_rows) % cfg.capacity
        state.size = min(state.size + n_rows, cfg.capacity)
        return {"teacher_solved": solved.to(F32).mean(), "rollout_episodes": done.sum(),
                "rollout_success": successes, "labeled_rows": labeled}

    def train(state: CemDaggerState, draws: DaggerDraws | None = None,
              generator: torch.Generator | None = None):
        return _train(state, cfg, lr_fn, None if draws is None else draws.idx, generator,
                      weighted=True)

    def iteration(state: CemDaggerState, beta: float, draws: DaggerDraws | None = None,
                  generator: torch.Generator | None = None):
        roll = collect(state, beta, draws, generator)
        return state, {**roll, **train(state, draws, generator)}

    iteration.collect, iteration.train = collect, train
    return iteration


def save_student(path, actor: GaussianActor, sac_cfg: sac_mod.SACConfig, view_dim: int,
                 act_dim: int, seed: int = 0) -> None:
    """Write the student as a whole SAC state in ``SACAgent.save``'s form
    (``{"state", "obs_dim", "action_dim", "total_steps"}``): the actor is the
    student, the critic, the targets and the optimizers a fresh template's,
    as the reference's artifact holds. ``eval.evaluate.load_agent_state``,
    ``python -m tvc_ai_torch.evaluate --model_path`` and
    ``training.warm_start_actor`` read it."""
    from pathlib import Path

    from tvc_ai_torch.utils.checkpoint import state_of

    dev = next(actor.parameters()).device
    template = sac_mod.init(view_dim, act_dim, sac_cfg, dev, seed)
    template.actor.load_state_dict(actor.state_dict())
    if template.ema_actor is not None:
        template.ema_actor.load_state_dict(actor.state_dict())
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save({"state": state_of(template), "obs_dim": view_dim, "action_dim": act_dim,
                "total_steps": 0}, tmp)
    tmp.replace(path)
