"""Batched deterministic evaluation: E episodes stepped together.

Counterpart of ``tvc_ai_tpu/eval/rollout.py``. All episodes run as one batch
with done-freezing: an episode that has ended keeps its last state and adds
nothing more to its statistics. The step is ``rocket_env.batched_step``, so
the physics runs in K1 on CUDA tensors (the reference steps the plain
integrator through ``vmap(rocket_env.step)``).

Where the reference scans the full horizon (``max_episode_steps``) in one
device program, the port steps eagerly and stops early once every episode
has ended: a finished episode's statistics are frozen, so the rest of the
horizon cannot change them. It reads ``done.all()`` from the device once
every ``check_every`` steps (32 by default), never more often.

Randomness is explicit: the reset's draws and each step's IMU noise and
sensor-dropout draw come from ``EvalDraws`` when given, otherwise from the
generator.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from tvc_ai_torch.agents import sac as sac_mod
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.rocket_env import ResetDraws
from tvc_ai_torch.env.types import EnvParams, EnvState
from tvc_ai_torch.models import hierarchical as hier_mod
from tvc_ai_torch.utils.tree import tree_map

CHECK_EVERY = 32  # steps between the early-exit reads of done.all()


class EpisodeStats(NamedTuple):
    returns: torch.Tensor        # (E,)
    lengths: torch.Tensor        # (E,) int32
    success: torch.Tensor        # (E,) bool
    crashed: torch.Tensor        # (E,) bool
    max_tilt: torch.Tensor       # (E,) rad
    max_angular_velocity: torch.Tensor  # (E,)
    mean_effort: torch.Tensor    # (E,)
    final_altitude: torch.Tensor  # (E,)
    fuel_used: torch.Tensor      # (E,)


@dataclasses.dataclass
class EvalDraws:
    """The random numbers one evaluation consumes: the reset's, and step t's
    in row t of ``n_imu`` (T, E, 7) when sensor noise is on and of
    ``u_drop`` (T, E) when sensor dropout is on."""

    reset: ResetDraws | None = None
    n_imu: torch.Tensor | None = None
    u_drop: torch.Tensor | None = None

    def step(self, t: int) -> tuple[torch.Tensor | None, torch.Tensor | None]:
        """Step t's (IMU noise, dropout draw); None where not given."""
        return (None if self.n_imu is None else self.n_imu[t],
                None if self.u_drop is None else self.u_drop[t])


def steps_run(lengths: torch.Tensor, horizon: int, check_every: int = CHECK_EVERY) -> int:
    """The steps an evaluation with these episode lengths ran: the rollout
    stops at the first multiple of ``check_every`` at or past the longest
    episode, or at the horizon."""
    longest = int(lengths.max())
    return min(horizon, -(-longest // check_every) * check_every)


def _freeze(done: torch.Tensor, new: EnvState, old: EnvState) -> EnvState:
    """``old`` where the episode had already ended, ``new`` elsewhere."""
    return tree_map(
        lambda n, o: torch.where(done.view(-1, *([1] * (n.dim() - 1))), o, n), new, old
    )


def _start(num_episodes: int, history_len: int, env_params: EnvParams,
           generator: torch.Generator | None, draws: EvalDraws | None):
    """Reset the episodes; returns (states, obs window or obs, device)."""
    if draws is not None and draws.reset is not None:
        device = draws.reset.u_init.device
    elif generator is not None:
        device = generator.device
    else:
        raise ValueError("give a generator or EvalDraws with the reset's draws")
    states, obs = rocket_env.reset(
        env_params, num_episodes, device, generator=generator,
        draws=draws.reset if draws is not None else None,
    )
    if history_len > 1:
        obs = obs[:, None, :].repeat(1, history_len, 1)
    return states, obs, device


def _advance_obs(obs: torch.Tensor, new_obs: torch.Tensor, done: torch.Tensor,
                 history_len: int) -> torch.Tensor:
    """Shift the new observation into the window (or replace the obs), frozen
    where the episode had already ended."""
    if history_len > 1:
        shifted = torch.cat([obs[:, 1:], new_obs[:, None, :]], dim=1)
        return torch.where(done[:, None, None], obs, shifted)
    return torch.where(done[:, None], obs, new_obs)


def make_policy_eval_fn(policy_fn: Callable, num_episodes: int, history_len: int = 1,
                        check_every: int = CHECK_EVERY):
    """Build ``eval_fn(agent, generator, env_params, draws=None) -> EpisodeStats``
    for a deterministic policy ``policy_fn(agent, obs) -> actions``.

    ``history_len`` > 1 feeds the policy a flattened [oldest..newest] window
    of observations; episodes never reset here, so the window only shifts.
    The rollout stops at the first multiple of ``check_every`` steps where
    every episode has ended, or at ``max_episode_steps``.
    """

    def eval_fn(agent, generator: torch.Generator | None, env_params: EnvParams,
                draws: EvalDraws | None = None) -> EpisodeStats:
        e = num_episodes
        states, obs, dev = _start(e, history_len, env_params, generator, draws)
        f32 = torch.float32
        done = torch.zeros(e, dtype=torch.bool, device=dev)
        ret = torch.zeros(e, dtype=f32, device=dev)
        length = torch.zeros(e, dtype=torch.int32, device=dev)
        success = torch.zeros(e, dtype=torch.bool, device=dev)
        crashed = torch.zeros(e, dtype=torch.bool, device=dev)
        max_tilt = torch.zeros(e, dtype=f32, device=dev)
        max_w = torch.zeros(e, dtype=f32, device=dev)
        effort_sum = torch.zeros(e, dtype=f32, device=dev)
        final_alt = torch.zeros(e, dtype=f32, device=dev)
        for t in range(env_params.max_episode_steps):
            if t > 0 and t % check_every == 0 and bool(done.all()):
                break
            view = obs.reshape(e, -1) if history_len > 1 else obs
            actions = policy_fn(agent, view)
            n_imu, u_drop = draws.step(t) if draws is not None else (None, None)
            new_states, out = rocket_env.batched_step(
                states, actions, env_params, generator=generator, n_imu=n_imu, u_drop=u_drop)
            live = ~done
            ret = ret + torch.where(live, out.reward, 0.0)
            length = length + live.to(torch.int32)
            success = success | (live & out.mission_success)
            crashed = crashed | (live & out.crashed)
            max_tilt = torch.maximum(max_tilt, torch.where(live, out.tilt, 0.0))
            max_w = torch.maximum(max_w, torch.where(live, out.angular_velocity_mag, 0.0))
            effort_sum = effort_sum + torch.where(
                live, torch.linalg.vector_norm(actions, dim=-1), 0.0)
            final_alt = torch.where(live, out.altitude, final_alt)
            states = _freeze(done, new_states, states)
            obs = _advance_obs(obs, out.obs, done, history_len)
            done = done | out.terminated | out.truncated
        return EpisodeStats(
            returns=ret,
            lengths=length,
            success=success,
            crashed=crashed,
            max_tilt=max_tilt,
            max_angular_velocity=max_w,
            mean_effort=effort_sum / torch.clamp(length.to(f32), min=1.0),
            final_altitude=final_alt,
            fuel_used=1.0 - states.fuel,
        )

    return eval_fn


def _sac_policy(obs_dim: int | None, history_len: int):
    """The SAC policy's deterministic action, the observation truncated to
    ``obs_dim`` per frame (legacy 8-D agents)."""

    def policy_fn(agent: sac_mod.SACState, obs: torch.Tensor) -> torch.Tensor:
        if obs_dim is not None:
            if history_len > 1:
                # frame size inferred (-1): env frames can be 10 or 14 (trim)
                frames = obs.reshape(obs.shape[0], history_len, -1)
                obs = frames[..., :obs_dim].reshape(obs.shape[0], -1)
            else:
                obs = obs[..., :obs_dim]
        return sac_mod.select_action(agent.actor, obs, deterministic=True)

    return policy_fn


def make_eval_fn(
    sac_cfg: sac_mod.SACConfig,
    num_episodes: int,
    action_dim: int = 2,
    obs_dim: int | None = None,
    history_len: int = 1,
    check_every: int = CHECK_EVERY,
):
    """SAC-policy specialization of ``make_policy_eval_fn``.

    ``obs_dim`` truncates the env's observation for agents trained on the
    legacy 8-D [quat, ω, fuel] layout; with history the truncation applies
    per frame. ``history_len`` must match the value the agent was trained
    with. ``sac_cfg`` and ``action_dim`` are the reference's arguments; the
    actor module carries both.
    """
    return make_policy_eval_fn(_sac_policy(obs_dim, history_len), num_episodes,
                               history_len=history_len, check_every=check_every)


def make_hier_eval_fn(
    sac_cfg: sac_mod.SACConfig,
    hier_cfg: hier_mod.HierarchicalConfig,
    num_episodes: int,
    action_dim: int = 2,
    history_len: int = 1,
    check_every: int = CHECK_EVERY,
):
    """Hierarchical evaluation: each step the high level picks its argmax
    goal from the newest frame, and the goal-conditioned SAC actor acts on
    [obs ‖ goal one-hot]. ``agent`` is ``(sac_state, high_state)``."""

    def policy_fn(agent, obs: torch.Tensor) -> torch.Tensor:
        sac_state, high_state = agent
        # newest frame of the flattened window (frame size inferred: 10 or 14)
        frame = obs.reshape(obs.shape[0], history_len, -1)[:, -1, :] if history_len > 1 else obs
        goal = hier_mod.sample_goal(high_state, frame, hier_cfg, deterministic=True)
        view = torch.cat([obs, hier_mod.one_hot(goal, hier_cfg.num_goals, obs.dtype)], dim=-1)
        return sac_mod.select_action(sac_state.actor, view, deterministic=True)

    return make_policy_eval_fn(policy_fn, num_episodes, history_len=history_len,
                               check_every=check_every)


def make_trajectory_fn(
    sac_cfg: sac_mod.SACConfig,
    num_episodes: int,
    action_dim: int = 2,
    obs_dim: int | None = None,
    history_len: int = 1,
):
    """Full-trajectory recorder: ``traj_fn(agent, generator, env_params,
    draws=None) -> dict`` of (T, E) series [altitude, tilt,
    angular_velocity, reward, live] and (T, E, A) actions over the whole
    horizon T = ``max_episode_steps`` (no early exit: the shapes are the
    reference's)."""
    policy_fn = _sac_policy(obs_dim, history_len)

    def traj_fn(agent, generator: torch.Generator | None, env_params: EnvParams,
                draws: EvalDraws | None = None) -> dict[str, torch.Tensor]:
        e = num_episodes
        states, obs, dev = _start(e, history_len, env_params, generator, draws)
        done = torch.zeros(e, dtype=torch.bool, device=dev)
        records = []
        for t in range(env_params.max_episode_steps):
            view = obs.reshape(e, -1) if history_len > 1 else obs
            actions = policy_fn(agent, view)
            n_imu, u_drop = draws.step(t) if draws is not None else (None, None)
            new_states, out = rocket_env.batched_step(
                states, actions, env_params, generator=generator, n_imu=n_imu, u_drop=u_drop)
            records.append({
                "altitude": out.altitude,
                "tilt": out.tilt,
                "angular_velocity": out.angular_velocity_mag,
                "reward": out.reward,
                "live": (~done).to(torch.float32),
                "action": actions,
            })
            states = _freeze(done, new_states, states)
            obs = _advance_obs(obs, out.obs, done, history_len)
            done = done | out.terminated | out.truncated
        return {k: torch.stack([r[k] for r in records]) for k in records[0]}

    return traj_fn


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_trajectories(series: dict, path, max_episodes: int = 8) -> None:
    """4-panel per-episode trajectory figure: altitude, tilt, |ω| and the
    gimbal commands over time; finished-episode tails are masked out."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    live = to_numpy(series["live"])  # (T, E)
    T, E = live.shape
    n = min(max_episodes, E)
    t = np.arange(T) * 0.02  # 50 Hz control steps → seconds
    fig, axes = plt.subplots(2, 2, figsize=(14, 8))

    def masked(name, ep):
        vals = to_numpy(series[name])[:, ep].astype(float)
        vals[~(live[:, ep] > 0.5)] = np.nan
        return vals

    for ep in range(n):
        axes[0, 0].plot(t, masked("altitude", ep), alpha=0.7, lw=1)
        axes[0, 1].plot(t, np.degrees(masked("tilt", ep)), alpha=0.7, lw=1)
        axes[1, 0].plot(t, masked("angular_velocity", ep), alpha=0.7, lw=1)
    axes[0, 0].set_title(f"Altitude (m) — first {n} episodes")
    axes[0, 1].set_title("Tilt (deg)")
    axes[0, 1].axhline(30, color="k", ls="--", lw=0.8, label="termination 30°")
    axes[0, 1].legend()
    axes[1, 0].set_title("|ω| (rad/s)")
    acts = to_numpy(series["action"])[:, 0, :]
    acts = np.where((live[:, 0] > 0.5)[:, None], acts, np.nan)
    axes[1, 1].plot(t, acts[:, 0], label="gimbal pitch", lw=1)
    axes[1, 1].plot(t, acts[:, 1], label="gimbal yaw", lw=1)
    axes[1, 1].set_title("Actions (episode 0)")
    axes[1, 1].set_ylim(-1.05, 1.05)
    axes[1, 1].legend()
    for ax in axes.flat:
        ax.grid(alpha=0.3)
        ax.set_xlabel("t (s)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def summarize_stats(stats: EpisodeStats) -> dict[str, float]:
    """Host-side aggregation with the reference's percentile set
    (p25/p50/p75/p90/p95) and its legacy success criterion."""
    returns = to_numpy(stats.returns)
    max_tilt, lengths = to_numpy(stats.max_tilt), to_numpy(stats.lengths)
    out = {
        "eval_reward_mean": float(returns.mean()),
        "eval_reward_std": float(returns.std()),
        "eval_success_rate": float(to_numpy(stats.success).mean()),
        "eval_crash_rate": float(to_numpy(stats.crashed).mean()),
        "eval_length_mean": float(lengths.mean()),
        "eval_max_tilt_mean": float(max_tilt.mean()),
        "eval_max_angular_velocity_mean": float(to_numpy(stats.max_angular_velocity).mean()),
        "eval_effort_mean": float(to_numpy(stats.mean_effort).mean()),
        "eval_fuel_used_mean": float(to_numpy(stats.fuel_used).mean()),
    }
    for p in (25, 50, 75, 90, 95):
        out[f"eval_reward_p{p}"] = float(np.percentile(returns, p))
    # the reference's own (weaker) success criterion: tilt stayed under 20°,
    # the episode outlived 200 steps, it ended above 0.5 m (max_tilt stands
    # in for its final-tilt check)
    legacy = (
        (max_tilt < np.radians(20.0))
        & (lengths > 200)
        & (to_numpy(stats.final_altitude) >= 0.5)
    )
    out["eval_legacy_success_rate"] = float(legacy.mean())
    return out
