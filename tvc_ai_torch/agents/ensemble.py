"""Multi-algorithm ensemble: PPO, SAC and TD3 sharing one batched simulator.

Counterpart of ``tvc_ai_tpu/agents/ensemble.py``. ``EnsembleCarry`` holds
the three members, the shared replay, the envs and the per-env counters;
``make_ensemble_iteration(actor)`` builds one iteration with ``actor`` ∈
{ppo, sac, td3, ensemble} acting. Each of its T steps:

1. acts with that member (SAC and PPO a tanh-Gaussian sample, TD3 its
   action plus exploration noise; no safety layer, as in the reference),
   or for ``ensemble`` with the blend of all three by the normalized
   performance weights (in ``ALGORITHMS`` order), clipped to [-1, 1];
2. steps the envs through ``rocket_env.batched_step_autoreset``: K1 on the
   card (the reference steps the plain ``vmap(step_autoreset)``);
3. writes the shared replay;
4. once the replay holds ``max(sac.learning_starts, sac.batch_size)`` rows
   (TD3's own ``learning_starts`` is never read), takes ``updates_per_step``
   SAC updates and ``updates_per_step`` TD3 updates (TD3 samples
   ``td3.batch_size`` rows);
5. keeps the episode books.

When PPO acted, its pre-tanh actions, log-probs and values feed
``ppo.learn`` (GAE and its epochs) after the last step.

The gate is decided on host ints (the replay's ``size``), so an iteration
makes no host-device synchronisation. With ``axis_name`` (data parallel,
``parallel.mesh``) every member's gradients are all-reduced over the ranks
(``mesh.sum_grads_``), and each step's metrics (one all-reduce) and the PPO
phase's metrics are averaged; each rank draws from its own generator. Randomness is explicit: one
``EnsembleStepDraws`` per step and one permutation per PPO epoch, or the
carry's generator.

``MultiAlgorithmAgent`` is the host side, as the reference has it: the
performance windows, the selector (dynamic, best or voting, with the
``selection_epsilon`` floor drawn from ``random.Random(seed ^ 0x5E1EC7)``),
the voting weights, ``get_action`` and the checkpoint (``torch.save`` of
the members with their optimizer states and step counts, the windows and
the weights; ``load_checkpoint`` also reads the JAX package's flax msgpack
one).
"""

from __future__ import annotations

import dataclasses
import random
import zipfile
from collections import deque
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from tvc_ai_torch.agents import ppo as ppo_mod
from tvc_ai_torch.agents import replay
from tvc_ai_torch.agents import sac as sac_mod
from tvc_ai_torch.agents import td3 as td3_mod
from tvc_ai_torch.agents.replay import ReplayBuffer
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.rocket_env import ResetDraws
from tvc_ai_torch.env.types import ACTION_DIM, OBS_DIM, EnvParams, EnvState
from tvc_ai_torch.parallel.mesh import pmean_
from tvc_ai_torch.training.loop import SampleDraws, StepDraws
from tvc_ai_torch.utils import flax_msgpack
from tvc_ai_torch.utils.checkpoint import load_state, state_of
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device

ALGORITHMS = ("ppo", "sac", "td3")
ACTORS = (*ALGORITHMS, "ensemble")
STEP_METRICS = ("sac_critic_loss", "sac_actor_loss", "alpha", "td3_critic_loss",
                "td3_actor_loss", "reward_mean")


@dataclasses.dataclass(frozen=True)
class EnsembleConfig:
    algorithms: tuple[str, ...] = ALGORITHMS
    selection_strategy: str = "dynamic"  # dynamic | best | voting
    performance_window: int = 100
    recent_window: int = 10  # the "last 10 episodes" of the dynamic strategy
    # probability of picking a member uniformly instead of the greedy argmax
    # (0.0 = the reference's pure greedy selection)
    selection_epsilon: float = 0.0
    sac: sac_mod.SACConfig = dataclasses.field(default_factory=sac_mod.SACConfig)
    td3: td3_mod.TD3Config = dataclasses.field(default_factory=td3_mod.TD3Config)
    ppo: ppo_mod.PPOConfig = dataclasses.field(default_factory=ppo_mod.PPOConfig)

    def __post_init__(self):
        object.__setattr__(self, "algorithms", tuple(self.algorithms))


@dataclasses.dataclass
class EnsembleCarry:
    """Everything the iteration threads from step to step; ``generator``
    stands in for the reference's ``key``."""

    env_states: EnvState
    obs: torch.Tensor             # (N, OBS_DIM)
    sac: sac_mod.SACState
    td3: td3_mod.TD3State
    ppo: ppo_mod.PPOState
    buffer: ReplayBuffer
    generator: torch.Generator
    env_steps: torch.Tensor       # (N,) int32
    episodes: torch.Tensor        # (N,) int32
    successes: torch.Tensor       # (N,) int32
    ep_return: torch.Tensor       # (N,) float32
    return_sum: torch.Tensor      # (N,) float32
    length_sum: torch.Tensor      # (N,) float32
    ep_length: torch.Tensor       # (N,) int32


@dataclasses.dataclass
class TD3Draws:
    """The random numbers one TD3 update consumes."""

    idx: torch.Tensor | None = None     # (td3.batch_size,) int64 replay rows
    noise: torch.Tensor | None = None   # (td3.batch_size, action_dim) target smoothing


@dataclasses.dataclass
class EnsembleStepDraws:
    """One step's draws: the env step's (``step.n_act`` is the acting
    member's (N, action_dim) noise, or (3, N, action_dim) for the blend, in
    ``ALGORITHMS`` order) and one draw per SAC and per TD3 update (read only
    where the step learns)."""

    step: StepDraws = dataclasses.field(default_factory=StepDraws)
    sac: Sequence[SampleDraws] = ()
    td3: Sequence[TD3Draws] = ()


def normalized_weights(weights) -> list[float]:
    """The (3,) performance weights divided by their sum, in float32."""
    w = np.asarray(weights, dtype=np.float32)
    return [float(x) for x in w / w.sum(dtype=np.float32)]


def policy_action(
    algo: str,
    carry: EnsembleCarry,
    obs: torch.Tensor,
    cfg: EnsembleConfig,
    weights=None,
    n_act: torch.Tensor | None = None,
    deterministic: bool = False,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """The action of one member, or for ``ensemble`` the blend of all three
    by ``weights`` (ALGORITHMS order) clipped to [-1, 1]."""
    if algo == "sac":
        return sac_mod.select_action(carry.sac.actor, obs, n_act, deterministic, generator)
    if algo == "td3":
        return td3_mod.select_action(carry.td3.actor, obs, cfg.td3, n_act, deterministic, generator)
    if algo == "ppo":
        return ppo_mod.select_action(carry.ppo, obs, deterministic, n_act, generator)
    if algo != "ensemble":
        raise ValueError(f"unknown acting algorithm {algo!r}; want one of {ACTORS}")
    noise = (None, None, None) if n_act is None else n_act.unbind(0)
    a_ppo = ppo_mod.select_action(carry.ppo, obs, deterministic, noise[0], generator)
    a_sac = sac_mod.select_action(carry.sac.actor, obs, noise[1], deterministic, generator)
    a_td3 = td3_mod.select_action(carry.td3.actor, obs, cfg.td3, noise[2], deterministic, generator)
    w = normalized_weights(weights)
    return torch.clamp(w[0] * a_ppo + w[1] * a_sac + w[2] * a_td3, -1.0, 1.0)


def init_carry(
    env_params: EnvParams,
    cfg: EnsembleConfig,
    num_envs: int,
    device: str | torch.device = DEFAULT_DEVICE,
    seed: int = 0,
    reset_draws: ResetDraws | None = None,
    stream_seed: int | None = None,
) -> EnsembleCarry:
    """Reset N envs, initialize the three members, allocate the shared
    replay (capacity ``sac.buffer_size`` rounded down to a multiple of N, at least
    N) and zero the counters. The members come from ``seed``; the carry's
    generator, which draws the resets, from ``stream_seed`` (default
    ``seed``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed if stream_seed is None else stream_seed)
    env_states, obs = rocket_env.reset(env_params, num_envs, dev, generator=gen, draws=reset_draws)
    example = {
        "obs": torch.zeros(OBS_DIM),
        "action": torch.zeros(ACTION_DIM),
        "reward": torch.zeros(()),
        "next_obs": torch.zeros(OBS_DIM),
        "done": torch.zeros(()),
    }
    size = cfg.sac.buffer_size
    capacity = max(size - size % num_envs, num_envs)

    def zeros(dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros(num_envs, dtype=dtype, device=dev)

    f32, i32 = torch.float32, torch.int32
    return EnsembleCarry(
        env_states=env_states,
        obs=obs,
        sac=sac_mod.init(OBS_DIM, ACTION_DIM, cfg.sac, dev, seed),
        td3=td3_mod.init(OBS_DIM, ACTION_DIM, cfg.td3, dev, seed + 2),
        ppo=ppo_mod.init(OBS_DIM, ACTION_DIM, cfg.ppo, dev, seed + 4),
        buffer=ReplayBuffer.create(capacity, example, dev),
        generator=gen,
        env_steps=zeros(i32), episodes=zeros(i32), successes=zeros(i32),
        ep_return=zeros(f32), return_sum=zeros(f32), length_sum=zeros(f32),
        ep_length=zeros(i32),
    )


def make_ensemble_iteration(
    actor_algo: str,
    cfg: EnsembleConfig,
    num_envs: int,
    rollout_steps: int,
    updates_per_step: int = 1,
    axis_name: str | None = None,
):
    """Build ``iteration(carry, weights, env_params, draws=None, perms=None)
    -> (carry, metrics)`` with ``actor_algo`` acting for ``rollout_steps``
    steps of ``num_envs`` envs. ``weights`` are the (3,) performance weights
    the ``ensemble`` actor blends by; ``draws`` holds one
    ``EnsembleStepDraws`` per step, ``perms`` one permutation per PPO epoch.
    ``metrics`` holds 0-dim device tensors: the per-step means of
    ``STEP_METRICS`` (the update metrics are zeros, and α its value, on
    steps that did not learn) and, when PPO acted, its update means as
    ``ppo_*``. With ``axis_name`` the metrics are averaged over the ranks."""
    if actor_algo not in ACTORS:
        raise ValueError(f"unknown acting algorithm {actor_algo!r}; want one of {ACTORS}")
    gate = max(cfg.sac.learning_starts, cfg.sac.batch_size)

    def learn(carry: EnsembleCarry, buffer: ReplayBuffer, d: EnsembleStepDraws) -> torch.Tensor:
        """``updates_per_step`` SAC then TD3 updates; their five metrics,
        each averaged over the updates."""
        for name, got in (("SAC", d.sac), ("TD3", d.td3)):
            if got and len(got) != updates_per_step:
                raise ValueError(f"{len(got)} {name} draws, want {updates_per_step}")
        gen = carry.generator
        sac_rows, td3_rows = [], []
        for u in range(updates_per_step):
            s = d.sac[u] if d.sac else SampleDraws()
            batch = replay.sample(buffer, cfg.sac.batch_size, s.idx, gen)
            _, m = sac_mod.update(carry.sac, batch, cfg.sac, s.update, gen, axis_name)
            sac_rows.append(torch.stack([m["critic_loss"], m["actor_loss"], m["alpha"]]))
        for u in range(updates_per_step):
            s = d.td3[u] if d.td3 else TD3Draws()
            batch = replay.sample(buffer, cfg.td3.batch_size, s.idx, gen)
            _, m = td3_mod.update(carry.td3, batch, cfg.td3, s.noise, gen, axis_name)
            td3_rows.append(torch.stack([m["critic_loss"], m["actor_loss"]]))
        if updates_per_step == 1:  # the mean of one: spare the launches
            return torch.cat([sac_rows[0], td3_rows[0]])
        return torch.cat([torch.stack(sac_rows).mean(0), torch.stack(td3_rows).mean(0)])

    def env_and_learn_step(carry: EnsembleCarry, weights, env_params: EnvParams,
                           d: EnsembleStepDraws, zero: torch.Tensor):
        gen, sd = carry.generator, d.step
        record = None
        if actor_algo == "ppo":
            actions, pre_tanh, logp, value = ppo_mod.act(carry.ppo, carry.obs, sd.n_act, gen)
            record = {"obs": carry.obs, "pre_tanh": pre_tanh, "log_prob": logp, "value": value}
        else:
            actions = policy_action(actor_algo, carry, carry.obs, cfg, weights, sd.n_act,
                                    generator=gen)
        env_states, out, next_obs = rocket_env.batched_step_autoreset(
            carry.env_states, actions, env_params, generator=gen, n_imu=sd.n_imu,
            reset_draws=sd.reset, u_drop=sd.u_drop)
        terminated = out.terminated.to(torch.float32)
        buffer = replay.add_batch(carry.buffer, {
            "obs": carry.obs,
            "action": actions,
            "reward": out.reward,
            "next_obs": out.obs,
            "done": terminated,
        })
        if buffer.size >= gate:   # host ints: no sync
            upd = learn(carry, buffer, d)
        else:
            upd = torch.stack([zero, zero, torch.exp(carry.sac.log_alpha), zero, zero])
        if record is not None:
            record.update(reward=out.reward, done=terminated)

        # ---- episode books, per env on the device
        done = out.terminated | out.truncated
        ep_return = carry.ep_return + out.reward
        ep_length = carry.ep_length + 1
        new_carry = dataclasses.replace(
            carry,
            env_states=env_states,
            obs=next_obs,
            buffer=buffer,
            env_steps=carry.env_steps + 1,
            episodes=carry.episodes + done.to(torch.int32),
            successes=carry.successes + (done & out.mission_success).to(torch.int32),
            return_sum=carry.return_sum + torch.where(done, ep_return, 0.0),
            length_sum=carry.length_sum + torch.where(done, ep_length.to(torch.float32), 0.0),
            ep_return=torch.where(done, 0.0, ep_return),
            ep_length=torch.where(done, 0, ep_length),
        )
        row = torch.cat([upd, out.reward.mean()[None]])
        # the update means and reward_mean, averaged over the ranks in one
        # all-reduce (α and the skipped updates' zeros are equal on every rank)
        pmean_([row], axis_name)
        return new_carry, row, record

    def iteration(carry: EnsembleCarry, weights, env_params: EnvParams,
                  draws: Sequence[EnsembleStepDraws] | None = None,
                  perms: Sequence[torch.Tensor] | None = None):
        if draws is not None and len(draws) != rollout_steps:
            raise ValueError(f"draws holds {len(draws)} steps, want {rollout_steps}")
        if carry.obs.shape[0] != num_envs:
            raise ValueError(f"the carry holds {carry.obs.shape[0]} envs, want {num_envs}")
        zero = torch.zeros((), device=carry.obs.device)
        empty = EnsembleStepDraws()
        rows, records = [], []
        for t in range(rollout_steps):
            carry, row, record = env_and_learn_step(
                carry, weights, env_params, draws[t] if draws is not None else empty, zero)
            rows.append(row)
            records.append(record)
        metrics = dict(zip(STEP_METRICS, torch.stack(rows).mean(0).unbind()))
        if actor_algo == "ppo":
            traj = {k: torch.stack([r[k] for r in records]) for k in records[0]}
            with torch.no_grad():
                last_value = carry.ppo.value(carry.obs)
            _, ppo_metrics = ppo_mod.learn(carry.ppo, traj, last_value, cfg.ppo, perms,
                                           carry.generator, axis_name)
            pmean_(ppo_metrics.values(), axis_name)
            metrics.update({f"ppo_{k}": v for k, v in ppo_metrics.items()})
        return carry, metrics

    return iteration


class MultiAlgorithmAgent:
    """The host orchestrator with the reference's public surface:
    ``select_algorithm`` / ``get_action`` / ``update_performance`` /
    ``save_checkpoint`` / ``load_checkpoint``. ``generator`` (on ``device``,
    seeded with ``seed``) draws ``get_action``'s noise."""

    def __init__(
        self,
        obs_dim: int = OBS_DIM,
        action_dim: int = ACTION_DIM,
        config: EnsembleConfig | None = None,
        seed: int = 0,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.config = config or EnsembleConfig()
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.performance_history: dict[str, deque] = {
            a: deque(maxlen=self.config.performance_window) for a in self.config.algorithms
        }
        self.algorithm_weights = {a: 1.0 for a in self.config.algorithms}
        self._current_algorithm: str | None = None
        self.carry: EnsembleCarry | None = None
        self._rng = random.Random(seed ^ 0x5E1EC7)  # selection-epsilon draws

    def attach_carry(self, carry: EnsembleCarry) -> None:
        self.carry = carry

    # ------------------------------------------------------------- selection
    def select_algorithm(self) -> str:
        """Performance-window selection (dynamic: the best mean of the last
        ``recent_window`` returns; best: of the whole window; voting: the
        blend), with the optional ``selection_epsilon`` uniform pick."""
        strategy = self.config.selection_strategy
        if (
            strategy != "voting"
            and self.config.selection_epsilon > 0
            and self._rng.random() < self.config.selection_epsilon
        ):
            selected = self._rng.choice(list(self.config.algorithms))
            self._current_algorithm = selected
            return selected
        if strategy == "voting":
            selected = "ensemble"
        else:
            window = self.config.recent_window if strategy == "dynamic" else None
            best, best_perf = None, -float("inf")
            for name, hist in self.performance_history.items():
                if len(hist) == 0:
                    continue
                vals = list(hist)[-window:] if window else list(hist)
                perf = float(np.mean(vals))
                if perf > best_perf:
                    best, best_perf = name, perf
            selected = best or "ppo"
        self._current_algorithm = selected
        return selected

    def update_performance(self, algorithm: str, episode_reward: float) -> None:
        if algorithm in self.performance_history:
            self.performance_history[algorithm].append(float(episode_reward))
        # performance-proportional weights for the voting blend
        means = {a: (np.mean(h) if len(h) else 0.0) for a, h in self.performance_history.items()}
        vals = np.array(list(means.values()), dtype=np.float64)
        if vals.std() > 0:
            w = np.exp((vals - vals.max()) / (vals.std() + 1e-8))
        else:
            w = np.ones_like(vals)
        for a, wi in zip(means, w / w.sum()):
            self.algorithm_weights[a] = float(wi)

    def weights_array(self) -> np.ndarray:
        """The weights in ``ALGORITHMS`` order, float32, on the host."""
        return np.asarray([self.algorithm_weights.get(a, 1.0) for a in ALGORITHMS], np.float32)

    # ---------------------------------------------------------------- action
    def get_action(self, obs, deterministic: bool = False, algorithm: str | None = None):
        """One or a batch of actions and an info dict ``{"algorithm": ...}``."""
        if self.carry is None:
            raise RuntimeError("attach_carry() first")
        algo = algorithm or self.select_algorithm()
        obs_t = torch.as_tensor(np.array(obs, np.float32), device=self.carry.obs.device)
        squeeze = obs_t.ndim == 1
        if squeeze:
            obs_t = obs_t[None]
        action = policy_action(algo, self.carry, obs_t, self.config, self.weights_array(),
                               deterministic=deterministic, generator=self.generator)
        action = torch.clamp(action, -1.0, 1.0).cpu().numpy()
        return (action[0] if squeeze else action), {"algorithm": algo}

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, path) -> None:
        """``torch.save`` of the carry without env states, obs and replay
        (the members with their optimizer states and step counts, the
        generator, the counters), the performance windows and the weights."""
        carry = (dataclasses.replace(self.carry, env_states=None, obs=None, buffer=None)
                 if self.carry is not None else None)
        payload = {
            "carry": state_of(carry),
            "performance_history": {a: list(h) for a, h in self.performance_history.items()},
            "algorithm_weights": dict(self.algorithm_weights),
        }
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        torch.save(payload, path)

    def load_checkpoint(self, path) -> None:
        """Restore the members (when a carry is attached), the windows and
        the weights from ``save_checkpoint``'s file, or from the JAX
        package's (``ensemble_final.msgpack``: flax msgpack of the carry
        without env states, obs and replay, the windows and the weights),
        whose members are carried across by ``convert`` at the attached
        carry's widths."""
        path = Path(path)
        if flax_msgpack.is_flax_msgpack(path):
            payload, members = flax_msgpack.load(path), self._members_from_flax
        elif zipfile.is_zipfile(path):
            payload = torch.load(path, map_location=self.device, weights_only=True)
            members = lambda saved: {  # noqa: E731
                m: load_state(getattr(self.carry, m), saved[m]) for m in ALGORITHMS}
        else:
            raise ValueError(f"{path}: neither an ensemble checkpoint of this package (a zip) "
                             "nor a flax msgpack one of the JAX package")
        saved = payload.get("carry")
        if self.carry is not None and saved:
            self.carry = dataclasses.replace(self.carry, **members(saved))
        for a, h in payload.get("performance_history", {}).items():
            self.performance_history[a] = deque(h, maxlen=self.config.performance_window)
        self.algorithm_weights.update(payload.get("algorithm_weights", {}))

    def _members_from_flax(self, saved: dict) -> dict:
        """The three members of a JAX ``EnsembleCarry`` in flax's state-dict
        form, on the attached carry's device at its observation width."""
        from tvc_ai_torch import convert

        obs_dim, dev = self.carry.obs.shape[-1], self.carry.obs.device
        return {
            "sac": convert.sac_state_from_numpy(saved["sac"], self.config.sac, obs_dim,
                                                ACTION_DIM, dev),
            "td3": convert.td3_state_from_numpy(saved["td3"], self.config.td3, obs_dim,
                                                ACTION_DIM, dev),
            "ppo": convert.ppo_state_from_numpy(saved["ppo"], self.config.ppo, obs_dim,
                                                ACTION_DIM, dev),
        }
