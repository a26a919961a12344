"""Evaluation suites: Standard / Robustness / Stress (+ CSV, JSON, dashboard).

Counterpart of ``tvc_ai_tpu/eval/evaluate.py``:

- Standard: 100 episodes, no randomization, 2000-step horizon
- Robustness: 200 episodes, domain randomization + sensor noise, 2000 steps
- Stress: 50 episodes, mass/thrust variation ±50 %, CG offset 0.1 m, 1500 steps

Each suite runs all its episodes as one batch (``eval.rollout``, K1 on the
card). ``load_agent_state`` reads the port's own checkpoints
(``utils.checkpoint``) and ``SACAgent.save`` files (``agents.legacy``), and
the JAX package's flax msgpack agent files (its ``SACAgent.save`` file, the
DAgger students) and orbax checkpoints (``utils.orbax_read``).
"""

from __future__ import annotations

import csv
import dataclasses
import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from tvc_ai_torch import convert
from tvc_ai_torch.agents import sac as sac_mod
from tvc_ai_torch.agents.legacy import fit_ema, read_agent_file
from tvc_ai_torch.env.types import EnvParams, as_float32
from tvc_ai_torch.env.single import RocketConfig
from tvc_ai_torch.eval.rollout import (
    EpisodeStats,
    make_eval_fn,
    steps_run,
    summarize_stats,
    to_numpy,
)
from tvc_ai_torch.utils.checkpoint import CheckpointManager, load_state
from tvc_ai_torch.utils.orbax_read import OrbaxCheckpoints
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class SuiteResult:
    name: str
    stats: EpisodeStats
    metrics: dict[str, float]
    seconds: float = 0.0   # host time of the rollout and its summary
    steps: int = 0         # steps the batched rollout ran before its early exit


def _suite_env_params(
    name: str,
    rocket_mass: float = 2.0,
    obs_overrides: dict[str, Any] | None = None,
    cg_offset_max: float | None = None,
    sensor_noise: bool | None = None,
) -> EnvParams:
    """Suite env construction. ``rocket_mass`` defaults to the current
    generation's nominal 2.0 kg (1.5 evaluates legacy-generation policies).
    ``obs_overrides`` maps EnvParams field names to values, applied verbatim;
    build it with ``obs_overrides_from_config`` from the run's config so the
    suites see the observation the policy trained on. ``cg_offset_max`` and
    ``sensor_noise`` are ablation knobs."""
    if name == "standard":
        params = RocketConfig(mass=rocket_mass).to_env_params(
            domain_randomization=False, sensor_noise=False, max_episode_steps=2000
        )
    elif name == "robustness":
        params = RocketConfig(mass=rocket_mass).to_env_params(
            domain_randomization=True, sensor_noise=True, max_episode_steps=2000
        )
    elif name == "stress":
        cfg = RocketConfig(
            mass=rocket_mass, mass_variation=0.5, thrust_variation=0.5,
            cg_offset_max=0.1,
        )
        params = cfg.to_env_params(
            domain_randomization=True, sensor_noise=True, max_episode_steps=1500
        )
    else:
        raise ValueError(f"unknown suite {name!r}")
    if cg_offset_max is not None:
        params = dataclasses.replace(params, randomization=dataclasses.replace(
            params.randomization, cg_offset_max=cg_offset_max))
    if sensor_noise is not None:
        params = dataclasses.replace(params, randomization=dataclasses.replace(
            params.randomization, sensor_noise_enabled=sensor_noise))
    if obs_overrides:
        params = dataclasses.replace(params, **obs_overrides)
    return as_float32(params)


def obs_overrides_from_config(cfg: Any) -> dict[str, Any]:
    """EnvParams observation-channel overrides from a ``FrameworkConfig``:
    the settings ``build_env_params`` applies, so suite evaluation rebuilds
    the training-time observation (``_suite_env_params`` rounds them to
    float32 as it does)."""
    trim = cfg.env.trim_observation
    drift = cfg.env.drift_observation
    out: dict[str, Any] = {}
    if trim.enabled:
        out.update(
            trim_obs_enabled=True,
            trim_obs_decay=trim.decay,
            trim_obs_tilt_scale=trim.tilt_scale,
            trim_obs_integral=trim.mode == "integral",
            trim_obs_clip=trim.integral_clip,
        )
    if drift.enabled:
        out.update(
            drift_obs_enabled=True,
            drift_obs_vel_scale=drift.vel_scale,
            drift_obs_pos_scale=drift.pos_scale,
        )
    if cfg.env.action_observation.enabled:
        out.update(action_obs_enabled=True)
    return out


SUITE_EPISODES = {"standard": 100, "robustness": 200, "stress": 50}


def run_suite(
    agent_state: sac_mod.SACState,
    sac_cfg: sac_mod.SACConfig,
    name: str,
    num_episodes: int | None = None,
    seed: int = 0,
    obs_dim: int | None = None,
    rocket_mass: float = 2.0,
    history_len: int = 1,
    obs_overrides: dict[str, Any] | None = None,
    cg_offset_max: float | None = None,
    sensor_noise: bool | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> SuiteResult:
    """One suite on ``device`` (the agent's); the draws come from a generator
    seeded with ``seed``."""
    dev = resolve_device(device)
    episodes = num_episodes or SUITE_EPISODES[name]
    env_params = _suite_env_params(
        name, rocket_mass, obs_overrides, cg_offset_max, sensor_noise
    )
    eval_fn = make_eval_fn(sac_cfg, episodes, obs_dim=obs_dim, history_len=history_len)
    t0 = time.perf_counter()
    stats = eval_fn(agent_state, torch.Generator(device=dev).manual_seed(seed), env_params)
    metrics = summarize_stats(stats)
    return SuiteResult(name=name, stats=stats, metrics=metrics,
                       seconds=time.perf_counter() - t0,
                       steps=steps_run(stats.lengths, env_params.max_episode_steps))


def run_all_suites(
    agent_state: sac_mod.SACState,
    sac_cfg: sac_mod.SACConfig,
    output_dir: str | Path,
    episodes_scale: float = 1.0,
    seed: int = 0,
    obs_dim: int | None = None,
    rocket_mass: float = 2.0,
    history_len: int = 1,
    obs_overrides: dict[str, Any] | None = None,
    cg_offset_max: float | None = None,
    sensor_noise: bool | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
) -> dict[str, SuiteResult]:
    """The three suites; writes ``<suite>_episodes.csv``,
    ``evaluation_summary.json`` and, when matplotlib imports,
    ``evaluation_dashboard.png``."""
    resolve_device(device)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    results = {}
    for name in ("standard", "robustness", "stress"):
        episodes = max(int(SUITE_EPISODES[name] * episodes_scale), 2)
        result = run_suite(
            agent_state, sac_cfg, name, episodes, seed, obs_dim, rocket_mass,
            history_len, obs_overrides, cg_offset_max, sensor_noise, device,
        )
        results[name] = result
        write_episode_csv(result, output_dir / f"{name}_episodes.csv")
    (output_dir / "evaluation_summary.json").write_text(
        json.dumps({k: v.metrics for k, v in results.items()}, indent=2)
    )
    try:
        plot_dashboard(results, output_dir / "evaluation_dashboard.png")
    except ImportError:
        pass  # matplotlib is optional: the CSVs and the JSON carry the numbers
    return results


def write_episode_csv(result: SuiteResult, path: Path) -> None:
    fields = EpisodeStats._fields
    arrays = [to_numpy(getattr(result.stats, f)) for f in fields]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(("episode",) + fields)
        for i in range(len(arrays[0])):
            writer.writerow([i] + [a[i].item() for a in arrays])


def plot_dashboard(results: dict[str, SuiteResult], path: Path) -> None:
    """8-panel evaluation dashboard."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 4, figsize=(20, 9))
    names = list(results)
    colors = dict(zip(names, ("tab:blue", "tab:orange", "tab:red")))

    def hist(ax, field, transform=lambda a: a, label=False):
        for n in names:
            ax.hist(transform(to_numpy(getattr(results[n].stats, field))), bins=20, alpha=0.5,
                    color=colors[n], label=n if label else None)

    def bars(ax, metric):
        ax.bar(names, [results[n].metrics[metric] for n in names],
               color=[colors[n] for n in names])
        ax.set_ylim(0, 1)

    hist(axes[0, 0], "returns", label=True)
    axes[0, 0].set_title("Episode reward distribution")
    axes[0, 0].legend()
    bars(axes[0, 1], "eval_success_rate")
    axes[0, 1].set_title("Success rate")
    hist(axes[0, 2], "lengths")
    axes[0, 2].set_title("Episode lengths")
    bars(axes[0, 3], "eval_crash_rate")
    axes[0, 3].set_title("Crash rate")
    hist(axes[1, 0], "max_tilt", np.degrees)
    axes[1, 0].axvline(30, color="k", linestyle="--", label="termination 30°")
    axes[1, 0].set_title("Max tilt (deg)")
    axes[1, 0].legend()
    hist(axes[1, 1], "max_angular_velocity")
    axes[1, 1].set_title("Max |ω| (rad/s)")
    hist(axes[1, 2], "mean_effort")
    axes[1, 2].set_title("Mean control effort")
    hist(axes[1, 3], "fuel_used")
    axes[1, 3].set_title("Fuel used")
    for ax in axes.flat:
        ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def load_agent_state(
    model_path: str | Path,
    obs_dim: int,
    action_dim: int,
    sac_cfg: sac_mod.SACConfig,
    device: str | torch.device = DEFAULT_DEVICE,
) -> sac_mod.SACState:
    """The agent of a checkpoint: a manager root (its latest step) or one step
    directory, of the port (a single process or a data-parallel run) or of
    the JAX package's orbax (``<run>/checkpoints_best/<step>``), whose EMA
    actor is preferred when it has one; or an agent file, restored whole
    (``agents.legacy.read_agent_file``): a ``SACAgent.save`` file of this
    package, or a flax msgpack file of the JAX package, ``{"state": SACState}``
    or the state alone, as the reference reads it. From an orbax checkpoint
    only ``carry/agent``'s chunks are decoded, and only the actor, the
    critics and ``log_alpha`` are taken, as the reference does."""
    dev = resolve_device(device)
    path = Path(model_path)
    template = sac_mod.init(obs_dim, action_dim, sac_cfg, dev)
    if path.is_file():
        return load_state(template, fit_ema(template, read_agent_file(path, dev)["state"]))
    mngr, step = CheckpointManager.locate(path)
    if isinstance(mngr, OrbaxCheckpoints):
        agent = mngr.read(step, prefix=("agent",))
        ema = agent.get("ema_actor_params")
        template.actor.load_state_dict(
            convert.actor_from_flax(ema if ema is not None else agent["actor_params"]))
        template.critic.load_state_dict(convert.critic_from_flax(agent["critic_params"]))
        template.target_critic.load_state_dict(
            convert.critic_from_flax(agent["target_critic_params"]))
        template.log_alpha = torch.tensor(np.asarray(agent["log_alpha"], np.float32),
                                          device=dev)
        return template
    # a data-parallel checkpoint's agent is replicated: rank 0's shard holds it
    world = mngr.world_of(step)
    payload, _ = mngr.restore(step, dev, rank=0, world=world)
    agent_state = payload["carry"]["agent"]
    ema = agent_state.get("ema_actor")
    load_state(template.actor, ema if ema is not None else agent_state["actor"])
    load_state(template.critic, agent_state["critic"])
    load_state(template.target_critic, agent_state["target_critic"])
    template.log_alpha = agent_state["log_alpha"]
    return template
