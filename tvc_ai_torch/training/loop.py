"""The fused SAC iteration: act, simulate, write replay, learn, keep books.

Counterpart of ``tvc_ai_tpu/training/loop.py``: ``TrainLoopConfig``,
``TrainCarry``, ``policy_obs_dim``, ``init_carry``, ``make_train_iteration``
(the per-step body and the chunked ``update_interval > 1`` path),
``drain_episodes`` and ``summarize``; ``collect`` is the act-only rollout.

Where the reference runs one ``lax.scan`` under ``jit``, the port runs the
same steps eagerly, in the same order, with no host-device synchronisation:
the replay's ``ptr`` and ``size`` are host ints, so the ``learning_starts``
gate is decided on the host; everything that depends on the data (episode
counters, the finished-episode ring) stays on the device. Randomness is
explicit: the iteration takes one ``IterDraws`` per step (the step's
``StepDraws`` and one ``SampleDraws`` per update), or draws everything from
the carry's generator.

The finished-episode ring: with more envs finishing in one step than the
ring has slots, the reference's scatter (``.at[slot].set(mode="drop")``) has
duplicate slots, and XLA applies them in order, so the last writer wins. The
port writes only the last ``episode_ring_size`` finishers of the step (their
slots are distinct), which gives the same ring deterministically.

The extensions, each in the reference's place in the step:

- ``use_curiosity``: the ICM's intrinsic reward on the newest frame, the
  action and the true next observation, from the parameters before the
  step's own ICM update, which follows over all N rows (with
  ``use_physics_informed``, regularized by the physics-informed loss);
- ``use_rnd``: the RND bonus on the true next observation; the predictor
  updates when the env-step count before the step is a multiple of
  ``rnd.update_frequency``, decided on the host from
  ``TrainCarry.env_steps_host``;
- ``use_hierarchical``: the SAC actor sees [obs ‖ goal one-hot] and the
  replay stores that view on both sides of a transition; a finished
  episode logs its goal and the frame it was chosen on into the ring, and
  its env draws a fresh goal from the high level (explicit Gumbel draws
  ``StepDraws.g_goal``, or the generator); at the iteration's end the high
  level takes one masked REINFORCE step over the episodes that iteration
  finished.

ICM, RND and goals run in the sim-only steps of ``update_interval > 1`` too.

``hoist_bookkeeping=True`` (the reference's opt-in chunk path; it needs
``update_interval`` K > 1, none of the three extensions, and a
``buffer_size`` that is a multiple of K·N, or it raises the reference's
``ValueError``): each chunk steps K lean sim steps with the agent fixed
(act, safety layer, K1, history window), writes their K·N replay rows in one
time-major block, runs one update event, does the episode accounting once,
vectorised over K (a segmented cumulative sum: ``cummax`` of the last done
before each step), and writes the finished-episode ring once over the K·N
flat entries with the same last-``episode_ring_size`` rule. It takes the
same ``IterDraws`` as the per-step cadence (each step's ``StepDraws``, the
chunk's ``SampleDraws`` on its last step) and computes the same iteration:
only the cumulative sums reorder float adds.

Data parallel (``axis_name``, ``parallel.mesh``): every learner's gradients
are all-reduced over the ranks (SAC's three, the ICM's, RND's with its
normalizer's batch statistics averaged, the high level's with its mean
return, flag and loss averaged; ``mesh.sum_grads_``); each step's metrics are averaged over the ranks in one
all-reduce (the update means where the step learned, ``reward_mean`` and
``done_frac``); every draw comes from the rank's own generator (or the
rank's ``IterDraws``). ``summarize`` then reports the global totals and
``drain_episodes`` gathers every rank's ring.

Refused by design, raising ``NotImplementedError``: ``use_pallas_physics=False``
on CUDA, which would route the default physics around K1.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from tvc_ai_torch.agents import replay as replay_mod
from tvc_ai_torch.agents import sac
from tvc_ai_torch.agents.physics_informed import PhysicsInformedConfig, make_icm_physics_loss
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.rocket_env import ResetDraws
from tvc_ai_torch.env.types import ACTION_DIM, OBS_DIM, EnvParams, EnvState
from tvc_ai_torch.models import curiosity as icm_mod
from tvc_ai_torch.models import hierarchical as hier_mod
from tvc_ai_torch.models import rnd as rnd_mod
from tvc_ai_torch.models.mlp import GaussianActor
from tvc_ai_torch.models.safety import SafetyConstraints, apply_safety
from tvc_ai_torch.models.transformer import TransformerActor
from tvc_ai_torch.parallel.mesh import DATA_AXIS, all_gather_host, pmean_, psum_host
from tvc_ai_torch.utils import profiling
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device

UPDATE_METRICS = ("critic_loss", "actor_loss", "alpha_loss", "alpha", "q1_mean",
                  "q2_mean", "entropy")


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
    """Shape and cadence of the fused loop and its extensions (the
    reference's fields)."""

    num_envs: int = 4096
    rollout_steps: int = 100
    updates_per_step: int = 1
    update_interval: int = 1
    obs_dim: int = OBS_DIM
    action_dim: int = ACTION_DIM
    use_safety_layer: bool = False
    use_curiosity: bool = False
    use_rnd: bool = False
    use_physics_informed: bool = False
    use_hierarchical: bool = False
    history_len: int = 1
    # None = auto (K1 whenever no opt-in physics term is on)
    use_pallas_physics: bool | None = None
    episode_ring_size: int = 256
    demo_fraction: float = 0.0
    hoist_bookkeeping: bool | None = None
    curiosity: icm_mod.CuriosityConfig = dataclasses.field(
        default_factory=icm_mod.CuriosityConfig)
    rnd: rnd_mod.RNDConfig = dataclasses.field(default_factory=rnd_mod.RNDConfig)
    physics_informed: PhysicsInformedConfig = dataclasses.field(
        default_factory=PhysicsInformedConfig)
    hierarchical: hier_mod.HierarchicalConfig = dataclasses.field(
        default_factory=hier_mod.HierarchicalConfig)
    safety: SafetyConstraints = dataclasses.field(default_factory=SafetyConstraints)


@dataclasses.dataclass
class TrainCarry:
    """Everything the iteration threads from step to step. ``generator`` is
    the counterpart of the reference's ``key``; ``env_steps_host`` is a
    host copy of ``env_steps[0]`` (every env's count is the same), which
    gates the RND update and masks the high level's episodes without a
    device read. The extension fields are None when their option is off."""

    env_states: EnvState            # (N, ...)
    obs: torch.Tensor               # (N, policy_obs_dim) current policy observations
    agent: sac.SACState
    buffer: replay_mod.ReplayBuffer
    generator: torch.Generator
    obs_window: torch.Tensor | None  # (N, history_len, obs_dim) or None
    env_steps: torch.Tensor         # (N,) int32 steps taken by each env slot
    episodes: torch.Tensor          # (N,) int32 finished episodes per slot
    successes: torch.Tensor         # (N,) int32 successful episodes per slot
    ep_return: torch.Tensor         # (N,) running episode return
    ep_length: torch.Tensor         # (N,) int32 running episode length
    return_sum: torch.Tensor        # (N,) sum of finished-episode returns
    length_sum: torch.Tensor        # (N,) sum of finished-episode lengths
    ep_ring_return: torch.Tensor    # (K,) float32
    ep_ring_length: torch.Tensor    # (K,) float32
    ep_ring_success: torch.Tensor   # (K,) float32
    ep_ring_seq: torch.Tensor       # (K,) int32 env-step counter at completion, -1 empty
    ep_ring_ptr: torch.Tensor       # (1,) int32 next write slot
    demo_buffer: replay_mod.ReplayBuffer | None = None  # sampled, never written
    icm: icm_mod.CuriosityState | None = None
    rnd: rnd_mod.RNDState | None = None
    hier: hier_mod.HighLevelState | None = None
    goal: torch.Tensor | None = None              # (N,) int32 per-episode goal
    goal_obs: torch.Tensor | None = None          # (N, obs_dim) frame at goal selection
    ep_ring_goal: torch.Tensor | None = None      # (K,) int32 episode goal
    ep_ring_goal_obs: torch.Tensor | None = None  # (K, obs_dim) frame at goal selection
    env_steps_host: int = 0


@dataclasses.dataclass
class StepDraws:
    """The random numbers one env step consumes (see ``rocket_env``)."""

    n_act: torch.Tensor | None = None   # (N, 2) exploration noise
    n_imu: torch.Tensor | None = None   # (N, 7) IMU noise of the new obs
    reset: ResetDraws | None = None     # the autoreset's draws
    u_drop: torch.Tensor | None = None  # (N,) U[0, 1) sensor-dropout draw
    g_goal: torch.Tensor | None = None  # (N, num_goals) Gumbel draws of the fresh goals


@dataclasses.dataclass
class SampleDraws:
    """The random numbers one update consumes: the replay rows, the demo
    rows (when ``demo_fraction > 0``) and the update's noise."""

    idx: torch.Tensor | None = None       # (B - n_demo,) int64
    idx_demo: torch.Tensor | None = None  # (n_demo,) int64
    update: sac.UpdateDraws | None = None


@dataclasses.dataclass
class IterDraws:
    """One step's draws: the env step's and one ``SampleDraws`` per update
    (read only where the step learns: with ``update_interval`` K > 1, hoisted
    or not, the last step of each chunk of K)."""

    step: StepDraws = dataclasses.field(default_factory=StepDraws)
    samples: Sequence[SampleDraws] = ()


def policy_obs_dim(loop_cfg: TrainLoopConfig) -> int:
    """What the agent sees: env obs × history [‖ goal one-hot]."""
    dim = loop_cfg.obs_dim * loop_cfg.history_len
    if loop_cfg.use_hierarchical:
        dim += loop_cfg.hierarchical.num_goals
    return dim


def augment_with_goal(obs: torch.Tensor, goal: torch.Tensor, loop_cfg: TrainLoopConfig
                      ) -> torch.Tensor:
    """[obs ‖ goal one-hot], the low level's conditioning."""
    return torch.cat(
        [obs, hier_mod.one_hot(goal, loop_cfg.hierarchical.num_goals, obs.dtype)], dim=-1)


def _check_axis(axis_name: str | None) -> None:
    if axis_name not in (None, DATA_AXIS):
        raise ValueError(f"unknown axis_name {axis_name!r}; the port has one axis, {DATA_AXIS!r}")


def example_transition(loop_cfg: TrainLoopConfig) -> dict[str, torch.Tensor]:
    """One replay row of zeros, no batch axis (the policy's view on both sides)."""
    dim = policy_obs_dim(loop_cfg)
    return {
        "obs": torch.zeros(dim),
        "action": torch.zeros(loop_cfg.action_dim),
        "reward": torch.zeros(()),
        "next_obs": torch.zeros(dim),
        "done": torch.zeros(()),
    }


def init_carry(
    env_params: EnvParams,
    sac_cfg: sac.SACConfig,
    loop_cfg: TrainLoopConfig,
    device: str | torch.device = DEFAULT_DEVICE,
    seed: int = 0,
    reset_draws: ResetDraws | None = None,
    stream_seed: int | None = None,
) -> TrainCarry:
    """Reset N envs, initialize the agent and the extensions that are on,
    allocate the replay (capacity ``buffer_size`` rounded down to a multiple
    of N, at least N) and zero the counters and the ring. With the
    hierarchical option the first goals are drawn from the generator. The
    networks come from ``seed``; the carry's generator, which draws the
    resets and the goals, from ``stream_seed`` (default ``seed``)."""
    dev = resolve_device(device)
    n = loop_cfg.num_envs
    gen = torch.Generator(device=dev).manual_seed(seed if stream_seed is None else stream_seed)
    env_states, obs = rocket_env.reset(env_params, n, dev, generator=gen, draws=reset_draws)
    obs_window = None
    if loop_cfg.history_len > 1:
        obs_window = obs[:, None, :].repeat(1, loop_cfg.history_len, 1)
        obs = obs_window.reshape(n, -1)
    agent = sac.init(policy_obs_dim(loop_cfg), loop_cfg.action_dim, sac_cfg, dev, seed)
    capacity = max(sac_cfg.buffer_size - sac_cfg.buffer_size % n, n)
    buffer = replay_mod.ReplayBuffer.create(capacity, example_transition(loop_cfg), dev)
    k = loop_cfg.episode_ring_size

    def zeros(size: int, dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros(size, dtype=dtype, device=dev)

    f32, i32 = torch.float32, torch.int32
    ext = {}
    if loop_cfg.use_curiosity:
        ext["icm"] = icm_mod.init(loop_cfg.curiosity, dev, seed + 7)
    if loop_cfg.use_rnd:
        ext["rnd"] = rnd_mod.init(loop_cfg.rnd, dev, seed + 11)
    if loop_cfg.use_hierarchical:
        hier = hier_mod.init_high(loop_cfg.obs_dim, loop_cfg.hierarchical, dev, seed + 13)
        goal_obs = obs_window[:, -1, :] if obs_window is not None else obs
        ext.update(
            hier=hier, goal_obs=goal_obs,
            goal=hier_mod.sample_goal(hier, goal_obs, loop_cfg.hierarchical, generator=gen),
            ep_ring_goal=zeros(k, i32),
            ep_ring_goal_obs=torch.zeros((k, loop_cfg.obs_dim), device=dev))
    return TrainCarry(
        env_states=env_states, obs=obs, agent=agent, buffer=buffer, generator=gen,
        obs_window=obs_window,
        env_steps=zeros(n, i32), episodes=zeros(n, i32), successes=zeros(n, i32),
        ep_return=zeros(n, f32), ep_length=zeros(n, i32),
        return_sum=zeros(n, f32), length_sum=zeros(n, f32),
        ep_ring_return=zeros(k, f32), ep_ring_length=zeros(k, f32),
        ep_ring_success=zeros(k, f32),
        ep_ring_seq=torch.full((k,), -1, dtype=i32, device=dev),
        ep_ring_ptr=zeros(1, i32),
        **ext,
    )


def ring_slots(done: torch.Tensor, ptr: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(slot of each env's finished episode, finishers in all).

    Finisher j (in env order) goes to ``(ptr + j) % size``; only the last
    ``size`` finishers are written, so the slots are distinct and the ring
    equals the reference's last-writer-wins scatter. Envs that write
    nothing get ``size``, one past the ring.
    """
    count = torch.cumsum(done.to(torch.int32), 0)
    total = count[-1]
    finished_before = count - 1
    keep = done & (finished_before >= total - size)
    slot = torch.where(keep, torch.remainder(ptr + finished_before, size), size)
    return slot, total


def ring_set(ring: torch.Tensor, slot: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``ring`` with ``values`` written at ``slot``; entries at slot
    ``len(ring)`` are dropped."""
    padded = torch.cat([ring, ring.new_zeros((1, *ring.shape[1:]))])
    padded.index_put_((slot,), values.to(ring.dtype).expand(slot.shape[0], *ring.shape[1:]))
    return padded[:-1]


def next_window(window: torch.Tensor | None, out_obs: torch.Tensor, next_obs: torch.Tensor,
                done: torch.Tensor):
    """(window, true next policy obs, next policy obs) after one env step.

    With a history window (N, H, obs_dim), the true next obs ``out_obs`` is
    shifted into it; where ``done``, the whole window is refilled with the
    fresh episode's first obs ``next_obs``. Both policy obs are the windows
    flattened to (N, H·obs_dim). Without one (``window`` None, history 1)
    the two obs pass through and nothing is launched."""
    if window is None:
        return window, out_obs, next_obs
    with profiling.span(profiling.HISTORY):
        shifted = torch.cat([window[:, 1:], out_obs[:, None, :]], dim=1)
        fresh = next_obs[:, None, :].expand(-1, window.shape[1], -1)
        window = torch.where(done[:, None, None], fresh, shifted)
        return window, shifted.reshape(shifted.shape[0], -1), window.reshape(window.shape[0], -1)


def make_train_iteration(
    sac_cfg: sac.SACConfig,
    loop_cfg: TrainLoopConfig,
    axis_name: str | None = None,
    act_fn=None,
):
    """Build ``train_iteration(carry, env_params, draws=None) -> (carry, metrics)``.

    One call runs ``rollout_steps`` env steps. With ``update_interval`` K ≤ 1
    every step writes replay and, once the buffer holds ``learning_starts``
    rows, takes ``updates_per_step`` SAC updates; the update metrics are
    averaged over all steps, the zeros of steps that did not learn included.
    With K > 1 each chunk is K − 1 sim-only steps and one learning step; the
    update metrics come from the learning step alone, ``reward_mean`` and
    ``done_frac`` average the whole chunk. ``hoist_bookkeeping=True`` runs
    each chunk as one hoisted chunk (the module docstring) and sets
    ``train_iteration.hoisted``. ``metrics`` holds 0-dim device tensors.
    ``axis_name`` (``parallel.mesh.DATA_AXIS``) runs the iteration as one
    rank of a data-parallel group.

    ``act_fn(agent, policy_input, n_act, generator) -> actions`` replaces the
    rollout's act path (default: ``sac.select_action`` on the agent's actor
    with the step's exploration noise ``n_act``, None when not drawn yet).
    """
    _check_axis(axis_name)
    if act_fn is None:
        def act_fn(agent, policy_input, n_act, generator):
            return sac.select_action(agent.actor, policy_input, n_act, generator=generator)
    k_int = loop_cfg.update_interval
    if loop_cfg.rollout_steps % max(k_int, 1) != 0:
        raise ValueError(
            f"rollout_steps ({loop_cfg.rollout_steps}) must be a multiple "
            f"of update_interval ({k_int})"
        )
    batch_size = sac_cfg.batch_size
    n_demo = (
        int(round(batch_size * loop_cfg.demo_fraction)) if loop_cfg.demo_fraction > 0 else 0
    )
    hoisted = bool(loop_cfg.hoist_bookkeeping)
    if hoisted and not (
        k_int > 1
        and not loop_cfg.use_hierarchical
        and not loop_cfg.use_curiosity
        and not loop_cfg.use_rnd
        and sac_cfg.buffer_size % (k_int * loop_cfg.num_envs) == 0
    ):
        raise ValueError(
            "hoist_bookkeeping=True requires update_interval>1, plain "
            "SAC features, and buffer_size divisible by "
            "update_interval*num_envs"
        )
    history, obs_dim = loop_cfg.history_len, loop_cfg.obs_dim
    ring_size = loop_cfg.episode_ring_size
    use_hier = loop_cfg.use_hierarchical
    phys_fn = (make_icm_physics_loss(loop_cfg.physics_informed)
               if loop_cfg.use_physics_informed else None)

    def batched_step(states, actions, env_params, d: StepDraws, generator):
        # use_pallas_physics mirrors the reference's field; every case runs
        # batched_step_autoreset, whose CPU path is the plain integrator.
        use = loop_cfg.use_pallas_physics
        if use is False and actions.device.type == "cuda":
            raise NotImplementedError(
                "use_pallas_physics=False on CUDA would bypass K1; the plain "
                "integrator runs on CUDA tensors only for the opt-in physics terms"
            )
        if use and not rocket_env.pallas_physics_ok(env_params):
            raise ValueError(
                "use_pallas_physics=True but an extra physics term (magnus/ground-"
                "effect/gyroscopic) is enabled; K1 implements parity physics only"
            )
        return rocket_env.batched_step_autoreset(
            states, actions, env_params, generator=generator, n_imu=d.n_imu,
            reset_draws=d.reset, u_drop=d.u_drop)

    def learn(agent, buffer, demo_buffer, samples, generator):
        """``updates_per_step`` updates, their metrics averaged."""
        if samples and len(samples) != loop_cfg.updates_per_step:
            raise ValueError(f"{len(samples)} SampleDraws, want {loop_cfg.updates_per_step}")
        per_update = []
        for u in range(loop_cfg.updates_per_step):
            s = samples[u] if samples else SampleDraws()
            if n_demo > 0:
                on = replay_mod.sample(buffer, batch_size - n_demo, s.idx, generator)
                demo = replay_mod.sample(demo_buffer, n_demo, s.idx_demo, generator)
                batch = {k: torch.cat([on[k], demo[k]]) for k in on}
                mask = torch.zeros(batch_size, device=on["obs"].device)
                mask[batch_size - n_demo:] = 1.0
                batch["demo_mask"] = mask
            else:
                batch = replay_mod.sample(buffer, batch_size, s.idx, generator)
            agent, m = sac.update(agent, batch, sac_cfg, s.update, generator, axis_name)
            per_update.append(m)
        if len(per_update) == 1:  # the mean of one: spare the launches
            return agent, per_update[0]
        return agent, {k: torch.stack([m[k] for m in per_update]).mean() for k in per_update[0]}

    def no_update_metrics(agent, zero):
        out = {name: zero for name in UPDATE_METRICS}
        out["alpha"] = torch.exp(agent.log_alpha)
        if n_demo > 0 and sac_cfg.bc_weight > 0:
            out["bc_loss"] = zero
        return out

    def env_and_learn_step(carry: TrainCarry, env_params: EnvParams, d: IterDraws,
                           learn_now: bool, zero: torch.Tensor):
        gen = carry.generator
        sd = d.step
        # --- act & simulate
        policy_input = augment_with_goal(carry.obs, carry.goal, loop_cfg) if use_hier else carry.obs
        actions = act_fn(carry.agent, policy_input, sd.n_act, gen)
        cur_frame = carry.obs[:, -obs_dim:] if history > 1 else carry.obs
        if loop_cfg.use_safety_layer:
            actions, _ = apply_safety(cur_frame, actions, loop_cfg.safety)
        env_states, out, next_obs = batched_step(carry.env_states, actions, env_params, sd, gen)

        done = out.terminated | out.truncated
        obs_window, stacked_next_true, stacked_next_policy = next_window(
            carry.obs_window, out.obs, next_obs, done)

        # --- intrinsic rewards; the ICM trains every step, from the
        # parameters that gave this step's reward
        reward = out.reward
        if loop_cfg.use_curiosity:
            reward = reward + icm_mod.intrinsic_reward(
                carry.icm, cur_frame, actions, out.obs, loop_cfg.curiosity)
            icm_mod.update(carry.icm, cur_frame, actions, out.obs, loop_cfg.curiosity,
                           physics_loss_fn=phys_fn, axis_name=axis_name)
        if loop_cfg.use_rnd:
            reward = reward + rnd_mod.intrinsic_reward(carry.rnd, out.obs, loop_cfg.rnd)
            if carry.env_steps_host % loop_cfg.rnd.update_frequency == 0:
                rnd_mod.update(carry.rnd, out.obs, loop_cfg.rnd, axis_name=axis_name)

        # --- replay write (terminated-only done: truncation bootstraps);
        # hierarchical mode stores the goal-augmented views
        stored_obs, stored_next = carry.obs, stacked_next_true
        if use_hier:
            stored_obs = policy_input
            stored_next = augment_with_goal(stacked_next_true, carry.goal, loop_cfg)
        buffer = replay_mod.add_batch(carry.buffer, {
            "obs": stored_obs,
            "action": actions,
            "reward": reward,
            "next_obs": stored_next,
            "done": out.terminated.to(torch.float32),
        })

        # --- learn, gated on learning_starts (host ints: no sync)
        learned = learn_now and buffer.size >= sac_cfg.learning_starts
        if learned:
            agent, upd_metrics = learn(carry.agent, buffer, carry.demo_buffer, d.samples, gen)
        else:
            agent, upd_metrics = carry.agent, no_update_metrics(carry.agent, zero)

        # --- episode bookkeeping, per env on the device
        ep_return = carry.ep_return + out.reward
        ep_length = carry.ep_length + 1
        success = done & out.mission_success
        episodes = carry.episodes + done.to(torch.int32)
        successes = carry.successes + success.to(torch.int32)
        return_sum = carry.return_sum + torch.where(done, ep_return, 0.0)
        length_sum = carry.length_sum + torch.where(done, ep_length.to(torch.float32), 0.0)
        slot, total = ring_slots(done, carry.ep_ring_ptr[0], ring_size)
        # hierarchical: log (goal, frame at selection) with the episode, and
        # give each finished env a fresh goal for its new episode
        goal, goal_obs = carry.goal, carry.goal_obs
        ep_ring_goal, ep_ring_goal_obs = carry.ep_ring_goal, carry.ep_ring_goal_obs
        if use_hier:
            ep_ring_goal = ring_set(ep_ring_goal, slot, goal)
            ep_ring_goal_obs = ring_set(ep_ring_goal_obs, slot, goal_obs)
            fresh_frame = obs_window[:, -1, :] if history > 1 else stacked_next_policy
            fresh_goal = hier_mod.sample_goal(carry.hier, fresh_frame, loop_cfg.hierarchical,
                                              sd.g_goal, gen)
            goal = torch.where(done, fresh_goal, goal)
            goal_obs = torch.where(done[:, None], fresh_frame, goal_obs)
        new_carry = TrainCarry(
            env_states=env_states,
            obs=stacked_next_policy,
            agent=agent,
            buffer=buffer,
            generator=gen,
            obs_window=obs_window,
            env_steps=carry.env_steps + 1,
            episodes=episodes,
            successes=successes,
            ep_return=torch.where(done, 0.0, ep_return),
            ep_length=torch.where(done, 0, ep_length),
            return_sum=return_sum,
            length_sum=length_sum,
            ep_ring_return=ring_set(carry.ep_ring_return, slot, ep_return),
            ep_ring_length=ring_set(carry.ep_ring_length, slot, ep_length),
            ep_ring_success=ring_set(carry.ep_ring_success, slot, success),
            ep_ring_seq=ring_set(carry.ep_ring_seq, slot, carry.env_steps[0]),
            ep_ring_ptr=torch.remainder(carry.ep_ring_ptr + total, ring_size).to(torch.int32),
            demo_buffer=carry.demo_buffer,
            icm=carry.icm,
            rnd=carry.rnd,
            hier=carry.hier,
            goal=goal,
            goal_obs=goal_obs,
            ep_ring_goal=ep_ring_goal,
            ep_ring_goal_obs=ep_ring_goal_obs,
            env_steps_host=carry.env_steps_host + 1,
        )
        step_metrics = dict(upd_metrics, reward_mean=out.reward.mean(),
                            done_frac=done.to(torch.float32).mean())
        # one all-reduce per step: the update means where the step learned
        # (a step that did not learn reports zeros and α, equal on every rank)
        pmean_([step_metrics[k] for k in step_metrics
                if learned or k in ("reward_mean", "done_frac")], axis_name)
        return new_carry, step_metrics

    def hoisted_chunk(carry: TrainCarry, env_params: EnvParams, ds: Sequence[IterDraws],
                      zero: torch.Tensor):
        """K sim steps with the agent fixed, then the chunk's replay write,
        update event, episode accounting and ring write, each once."""
        gen, agent = carry.generator, carry.agent
        env_states, obs, window = carry.env_states, carry.obs, carry.obs_window
        n, k = obs.shape[0], k_int
        ys = []
        for d in ds:
            sd = d.step
            actions = act_fn(agent, obs, sd.n_act, gen)
            if loop_cfg.use_safety_layer:
                cur_frame = obs[:, -obs_dim:] if history > 1 else obs
                actions, _ = apply_safety(cur_frame, actions, loop_cfg.safety)
            env_states, out, next_obs = batched_step(env_states, actions, env_params, sd, gen)
            window, next_true, next_policy = next_window(
                window, out.obs, next_obs, out.terminated | out.truncated)
            ys.append((obs, actions, out.reward, next_true, out.terminated, out.truncated,
                       out.mission_success))
            obs = next_policy
        s_obs, s_act, s_rew, s_next, s_term, s_trunc, s_succ = zip(*ys)
        s_rew, s_term = torch.stack(s_rew), torch.stack(s_term)

        # --- replay: one time-major block of K·N rows, the rows K per-step
        # writes would make, in their order
        buffer = replay_mod.add_batch(carry.buffer, {
            "obs": torch.cat(s_obs),
            "action": torch.cat(s_act),
            "reward": s_rew.reshape(-1),
            "next_obs": torch.cat(s_next),
            "done": s_term.reshape(-1).to(torch.float32),
        })

        # --- one update event per chunk
        learned = buffer.size >= sac_cfg.learning_starts
        if learned:
            agent, upd_metrics = learn(agent, buffer, carry.demo_buffer, ds[-1].samples, gen)
        else:
            upd_metrics = no_update_metrics(agent, zero)

        # --- episode accounting over the chunk: the running return
        # restarts after each done, a segmented cumulative sum from the
        # index of the last done strictly before each step (-1: none)
        i32 = torch.int32
        done_kn = s_term | torch.stack(s_trunc)
        succ_kn = done_kn & torch.stack(s_succ)
        t_idx = torch.arange(k, dtype=i32, device=obs.device)[:, None]
        done_t = torch.where(done_kn, t_idx, -1)
        ldb = torch.cat([torch.full((1, n), -1, dtype=i32, device=obs.device),
                         torch.cummax(done_t, dim=0).values[:-1]])
        fresh_seg = ldb < 0   # the episode began before the chunk
        cum_rew = torch.cumsum(s_rew, dim=0)
        cum_at_ldb = torch.gather(cum_rew, 0, ldb.clamp(min=0).to(torch.int64))
        # the running return and length including step t, before a reset at t
        ring_ret = (torch.where(fresh_seg, carry.ep_return[None, :], 0.0) + cum_rew
                    - torch.where(fresh_seg, 0.0, cum_at_ldb))
        ring_len = (torch.where(fresh_seg, carry.ep_length[None, :], 0)
                    + (t_idx - ldb)).to(torch.float32)

        # --- the finished-episode ring: one flat time-major write
        done_flat = done_kn.reshape(-1)
        slot, total = ring_slots(done_flat, carry.ep_ring_ptr[0], ring_size)
        seq = (carry.env_steps[0] + t_idx).expand(k, n).reshape(-1)
        new_carry = dataclasses.replace(
            carry,
            env_states=env_states,
            obs=obs,
            agent=agent,
            buffer=buffer,
            obs_window=window,
            env_steps=carry.env_steps + k,
            episodes=carry.episodes + done_kn.sum(0, dtype=i32),
            successes=carry.successes + succ_kn.sum(0, dtype=i32),
            ep_return=torch.where(done_kn[-1], 0.0, ring_ret[-1]),
            ep_length=torch.where(done_kn[-1], 0, ring_len[-1].to(i32)),
            return_sum=carry.return_sum + torch.where(done_kn, ring_ret, 0.0).sum(0),
            length_sum=carry.length_sum + torch.where(done_kn, ring_len, 0.0).sum(0),
            ep_ring_return=ring_set(carry.ep_ring_return, slot, ring_ret.reshape(-1)),
            ep_ring_length=ring_set(carry.ep_ring_length, slot, ring_len.reshape(-1)),
            ep_ring_success=ring_set(carry.ep_ring_success, slot, succ_kn.reshape(-1)),
            ep_ring_seq=ring_set(carry.ep_ring_seq, slot, seq),
            ep_ring_ptr=torch.remainder(carry.ep_ring_ptr + total, ring_size).to(i32),
            env_steps_host=carry.env_steps_host + k,
        )
        metrics = dict(upd_metrics, reward_mean=s_rew.mean(),
                       done_frac=done_kn.to(torch.float32).mean())
        # the learning step's all-reduce of the per-step path
        pmean_([metrics[name] for name in metrics
                if learned or name in ("reward_mean", "done_frac")], axis_name)
        return new_carry, metrics

    def mean_over(rows: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
        return {k: torch.stack([r[k] for r in rows]).mean() for k in rows[0]}

    def train_iteration(carry: TrainCarry, env_params: EnvParams,
                        draws: Sequence[IterDraws] | None = None):
        steps = loop_cfg.rollout_steps
        if draws is not None and len(draws) != steps:
            raise ValueError(f"draws holds {len(draws)} steps, want {steps}")
        zero = torch.zeros((), device=carry.obs.device)
        empty = IterDraws()
        iter_start = carry.env_steps_host
        rows = []
        if hoisted:
            for c in range(0, steps, k_int):
                ds = draws[c:c + k_int] if draws is not None else [empty] * k_int
                carry, m = hoisted_chunk(carry, env_params, ds, zero)
                rows.append(m)
        elif k_int <= 1:
            for t in range(steps):
                carry, m = env_and_learn_step(
                    carry, env_params, draws[t] if draws is not None else empty, True, zero)
                rows.append(m)
        else:
            for c in range(steps // k_int):
                sim = []
                for j in range(k_int):
                    t = c * k_int + j
                    carry, m = env_and_learn_step(
                        carry, env_params, draws[t] if draws is not None else empty,
                        j == k_int - 1, zero)
                    sim.append(m)
                merged = dict(sim[-1])
                for name in ("reward_mean", "done_frac"):
                    merged[name] = torch.stack([m[name] for m in sim]).sum() / k_int
                rows.append(merged)
        metrics = mean_over(rows)
        if use_hier:
            # REINFORCE on this iteration's finished episodes (older ring
            # entries are masked out)
            mask = (carry.ep_ring_seq >= iter_start).to(torch.float32)
            _, hier_metrics = hier_mod.update_high_masked(
                carry.hier, carry.ep_ring_goal_obs, carry.ep_ring_goal, carry.ep_ring_return,
                mask, loop_cfg.hierarchical, axis_name)
            metrics.update(hier_metrics)
        return carry, metrics

    train_iteration.hoisted = hoisted
    return train_iteration


def drain_episodes(carry: TrainCarry, last_seq: int, axis_name: str | None = None
                   ) -> tuple[list[tuple[float, int, bool]], int]:
    """Finished episodes newer than ``last_seq`` from the ring, in completion
    order, as ``(return, length, success)``; and the newest ``seq``. Ring
    overflow keeps only the most recent ``episode_ring_size``. With
    ``axis_name`` every rank's ring is gathered (rank by rank, as the
    reference's host gather concatenates the shards), so every rank drains
    the same episodes."""
    rings = torch.stack([r.to(torch.float64) for r in (
        carry.ep_ring_return, carry.ep_ring_length, carry.ep_ring_success, carry.ep_ring_seq)])
    rets, lens, succ, seq = all_gather_host(rings[None], axis_name).transpose(0, 1).reshape(
        4, -1).numpy()
    new = seq > last_seq
    if not new.any():
        return [], last_seq
    order = np.argsort(seq[new], kind="stable")
    episodes = [
        (float(r), int(l), bool(s > 0.5))
        for r, l, s in zip(rets[new][order], lens[new][order], succ[new][order])
    ]
    return episodes, int(seq.max())


COUNTERS = ("env_steps", "episodes", "successes", "return_sum", "length_sum")


def counter_totals(carry: TrainCarry, axis_name: str | None = None) -> dict[str, float]:
    """The sums of the per-env counters (over every rank with ``axis_name``):
    one all-reduce, one read."""
    return dict(zip(COUNTERS, psum_host([getattr(carry, k).sum() for k in COUNTERS],
                                        axis_name)))


def summarize(carry: TrainCarry, axis_name: str | None = None,
              totals: dict[str, float] | None = None) -> dict[str, Any]:
    """Host-side snapshot of the counters, global with ``axis_name``
    (``totals`` from ``counter_totals`` spares the read)."""
    t = counter_totals(carry, axis_name) if totals is None else totals
    eps = max(int(t["episodes"]), 1)
    return {
        "env_steps": int(t["env_steps"]),
        "episodes": int(t["episodes"]),
        "success_rate": t["successes"] / eps,
        "mean_episode_return": t["return_sum"] / eps,
        "mean_episode_length": t["length_sum"] / eps,
        "buffer_size": carry.buffer.size,
    }


@dataclasses.dataclass
class Rollout:
    states: EnvState
    obs: torch.Tensor          # (N, history_len·obs_dim) policy observation after the last step
    reward: torch.Tensor       # (steps, N)
    terminated: torch.Tensor   # (steps, N)
    truncated: torch.Tensor    # (steps, N)


def collect(
    actor: GaussianActor | TransformerActor,
    env_states: EnvState,
    obs: torch.Tensor,
    env_params: EnvParams,
    steps: int,
    safety: SafetyConstraints | None = SafetyConstraints(),
    generator: torch.Generator | None = None,
    draws: Sequence[StepDraws] | None = None,
    history_len: int = 1,
) -> Rollout:
    """Run ``steps`` act-and-simulate steps for the N envs in ``env_states``
    (nothing learned).

    Each step samples a tanh-Gaussian action, applies the safety projection
    (skipped when ``safety`` is None), then ``batched_step_autoreset`` (the K1
    kernel on CUDA). ``draws`` gives each step's random numbers; otherwise
    they come from ``generator`` on the envs' device.

    With ``history_len`` H > 1, ``obs`` is the window of the last H
    observations, newest last, flattened to (N, H·obs_dim) as ``init_carry``
    starts it: the actor sees the window, the safety projection its newest
    frame, and after each step ``next_window`` shifts the true next
    observation in, or refills the window with the fresh episode's first
    observation where the episode ended. The returned ``obs`` is the window,
    flattened.
    """
    if draws is not None and len(draws) != steps:
        raise ValueError(f"draws holds {len(draws)} steps, want {steps}")
    window = obs.view(obs.shape[0], history_len, -1) if history_len > 1 else None
    rewards, terminated, truncated = [], [], []
    for t in range(steps):
        d = draws[t] if draws is not None else StepDraws()
        with profiling.span(profiling.ACT):
            actions = sac.select_action(actor, obs, d.n_act, generator=generator)
            if safety is not None:
                # the newest frame, held by no name: the env step's obs is a view
                # of its whole output, which a name would keep alive a step longer
                actions, _ = apply_safety(obs if window is None else window[:, -1], actions,
                                          safety)
        env_states, out, obs = rocket_env.batched_step_autoreset(
            env_states, actions, env_params,
            generator=generator, n_imu=d.n_imu, reset_draws=d.reset, u_drop=d.u_drop,
        )
        if window is not None:
            window, _, obs = next_window(window, out.obs, obs, out.terminated | out.truncated)
        rewards.append(out.reward)
        terminated.append(out.terminated)
        truncated.append(out.truncated)
    return Rollout(
        states=env_states,
        obs=obs,
        reward=torch.stack(rewards),
        terminated=torch.stack(terminated),
        truncated=torch.stack(truncated),
    )
