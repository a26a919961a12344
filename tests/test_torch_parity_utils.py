"""Shared helpers for the tvc_ai_torch parity tests, and their own checks.

The port takes its random numbers as explicit tensors; these helpers replay
the JAX package's per-env key chain to produce exactly the draws a JAX call
consumes, so both packages can be fed the same numbers:

- reset: ``rocket_env.py`` splits the key into (k_dr, k_init, k_noise,
  k_next) with sensor noise on (three keys without); the domain draw splits
  k_dr into (ku, kn) for uniform(7) and normal(3), or, with
  ``feasible_only``, splits kn again into (ku2, kn2) for the candidates'
  uniform(K, 4) and normal(K, 3) (normal(kn, 3) is then not drawn); k_init
  gives the uniform(7) initial-state draw; k_noise the normal(7) IMU noise
  (no dropout draw at reset);
- step: ``_pre_physics`` splits the carried key into (key, k_noise) when
  sensor noise or sensor dropout is on; with both on ``_observe`` splits
  k_noise into (kn, kd), the IMU noise is normal(kn, 7) and the dropout
  draw is ``bernoulli(kd, p)``, i.e. uniform(kd, ()) < p; with one of them
  on, that one draws from k_noise itself; ``_finish_autoreset`` splits
  ``key`` into (k_reset, k_carry) and resets from k_reset;
- train iteration (``training/loop.py``): each step splits the carry's key
  into (k_act, k_sample, k_update, k_next); the action noise is
  normal(k_act, (N, A)); in hierarchical mode the fresh goals are
  categorical(fold_in(k_act, 17), logits), i.e. the argmax of the logits plus
  gumbel(fold_in(k_act, 17), (N, num_goals)); each update splits its key, starting from
  k_update, into (k_s, k_d, k_u, key); the replay rows are
  randint(k_s, (B - n_demo,), 0, max(size, 1)), the demo rows
  randint(k_d, (n_demo,), 0, max(demo size, 1)); ``sac.update`` splits k_u
  into (k_next, k_pi), each drawing normal(·, (B, A));
- the hoisted chunk (``hoist_bookkeeping``, K steps a chunk): each chunk
  splits the carry's key into (k_act_all, k_sample_update, k_chain) and
  k_act_all into K keys, step j's action noise being normal(key j, (N, A));
  the chunk's one update event splits from k_sample_update as above, and
  the carry's key moves on to k_chain (``hoisted_iteration_draws``);
- PPO epochs: each splits the key into (key, k_perm, k_up) and permutes the
  T·N rows with permutation(k_perm, T·N);
- where a JAX iteration vmaps ``rocket_env.step_autoreset`` itself (PPO,
  the ensemble), ``record_env_keys`` records the env keys it receives;
- data parallel (``shard_map`` over the ``data`` axis): each step folds the
  rank into the carry's key, ``fold_in(key, r)``, and splits the draws from
  that, while the carry's key moves on by ``split(key, 1)[0]`` on every rank
  alike (``iteration_draws`` and ``ensemble_draws`` with ``rank``; the
  ensemble's chain moves so without ranks too);
  ``record_env_keys_sharded`` records each rank's env keys, and ``shard_of``
  takes rank r's part of a sharded JAX tree.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvc_ai_torch.agents.sac import UpdateDraws
from tvc_ai_torch.convert import env_params_from_numpy
from tvc_ai_torch.env import rocket_env as t_env
from tvc_ai_torch.env.rocket_env import ResetDraws
from tvc_ai_torch.training.loop import IterDraws, SampleDraws, StepDraws
from tvc_ai_tpu.agents import replay as j_replay
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig, RewardConfig, SuccessConfig
from tvc_ai_tpu.physics import quaternion as j_quat

torch.set_num_threads(1)


def _domain_draws_one(k_dr, rnd) -> dict:
    """The draws ``sample_domain_params(k_dr, ..)`` consumes."""
    out = {}
    if rnd.enabled or rnd.sensor_noise_uniform or rnd.progress_rate_randomized:
        ku, kn = jax.random.split(k_dr)
        out["u_dr"] = jax.random.uniform(ku, (7,), minval=-1.0, maxval=1.0)
        if rnd.enabled and rnd.feasible_only:
            ku2, kn2 = jax.random.split(kn)
            out["u_feas"] = jax.random.uniform(ku2, (rnd.feasible_tries, 4), minval=-1.0,
                                               maxval=1.0)
            out["n_feas"] = jax.random.normal(kn2, (rnd.feasible_tries, 3))
        elif rnd.enabled:
            out["n_dr"] = jax.random.normal(kn, (3,))
    return out


def _reset_draws_one(key, params):
    rnd = params.randomization
    if rnd.sensor_noise_enabled:
        k_dr, k_init, k_noise, _ = jax.random.split(key, 4)
    else:
        k_dr, k_init, _ = jax.random.split(key, 3)
    out = {"u_init": jax.random.uniform(k_init, (7,), minval=-1.0, maxval=1.0),
           **_domain_draws_one(k_dr, rnd)}
    if rnd.sensor_noise_enabled:
        out["n_imu"] = jax.random.normal(k_noise, (7,))
    return out


def reset_key_left(key, params):
    """The key ``reset(key, params)`` leaves in the state."""
    return jax.random.split(key, 4 if params.randomization.sensor_noise_enabled else 3)[-1]


def step_obs_draws(key, params) -> tuple:
    """(the key left, {n_imu, u_drop}) of one ``step`` of a state carrying
    ``key``: the IMU noise and the dropout draw of the new observation."""
    rnd = params.randomization
    out = {}
    if not (rnd.sensor_noise_enabled or rnd.sensor_dropout_enabled):
        return key, out
    key, k_noise = jax.random.split(key)
    if rnd.sensor_noise_enabled and rnd.sensor_dropout_enabled:
        kn, kd = jax.random.split(k_noise)
    else:
        kn = kd = k_noise
    if rnd.sensor_noise_enabled:
        out["n_imu"] = jax.random.normal(kn, (7,))
    if rnd.sensor_dropout_enabled:
        out["u_drop"] = jax.random.uniform(kd, ())
    return key, out


def _step_draws_one(key, params):
    key, out = step_obs_draws(key, params)
    k_reset, _ = jax.random.split(key)
    out["reset"] = _reset_draws_one(k_reset, params)
    return out


def to_reset_draws(d: dict) -> ResetDraws:
    return ResetDraws(**{k: torch.from_numpy(np.array(v)) for k, v in d.items()})


class KeyChain:
    """Jitted replays of the JAX draws for one parameterization."""

    def __init__(self, params: EnvParams):
        self._reset = jax.jit(jax.vmap(lambda k: _reset_draws_one(k, params)))
        self._step = jax.jit(jax.vmap(lambda k: _step_draws_one(k, params)))

    def reset(self, keys) -> ResetDraws:
        """Draws of ``vmap(reset)(keys, params)``."""
        return to_reset_draws(self._reset(keys))

    def step(self, state_keys) -> StepDraws:
        """The draws (IMU noise, dropout draw, autoreset draws; no action
        noise) that the next ``step_autoreset`` of states carrying
        ``state_keys`` consumes."""
        d = self._step(state_keys)
        return StepDraws(n_imu=to_torch(d["n_imu"]) if "n_imu" in d else None,
                         u_drop=to_torch(d["u_drop"]) if "u_drop" in d else None,
                         reset=to_reset_draws(d["reset"]))


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def update_draws(key, batch: int, action_dim: int) -> UpdateDraws:
    """The noise ``sac.update(.., key, ..)`` draws for a batch."""
    k_next, k_pi = jax.random.split(key)
    return UpdateDraws(n_next=to_torch(jax.random.normal(k_next, (batch, action_dim))),
                       n_pi=to_torch(jax.random.normal(k_pi, (batch, action_dim))))


def sample_idx(key, n: int, size: int) -> torch.Tensor:
    """The rows ``replay.sample`` draws from a buffer holding ``size`` rows."""
    idx = jax.random.randint(key, (n,), 0, jnp.maximum(jnp.int32(size), 1))
    return to_torch(idx).to(torch.int64)


def rank_keys(key, rank: int | None, parts: int):
    """(the step's ``parts`` keys, the carry's next key): ``split(key,
    parts)`` and its last part without data parallelism; ``split(fold_in(key,
    rank), parts)`` and ``split(key, 1)[0]`` for rank ``rank``."""
    if rank is None:
        keys = jax.random.split(key, parts)
        return keys, keys[-1]
    return jax.random.split(jax.random.fold_in(key, rank), parts), jax.random.split(key, 1)[0]


def iteration_draws(chain: KeyChain, key, env_keys, sizes, sac_cfg, loop_cfg,
                    demo_size: int = 0, rank: int | None = None) -> list[IterDraws]:
    """Every draw of one JAX ``make_train_iteration`` call, from the carry's
    key, the envs' keys before each step (T, N, 2) and the buffer's size after
    each step's write. Steps that take no update get no ``SampleDraws``.
    ``rank`` replays data-parallel rank ``rank``'s draws (``loop_cfg`` and
    ``sac_cfg`` are then the rank's local configs)."""
    n, a = loop_cfg.num_envs, loop_cfg.action_dim
    every = max(loop_cfg.update_interval, 1)
    out = []
    for t in range(loop_cfg.rollout_steps):
        (k_act, _, k_update, _), key = rank_keys(key, rank, 4)
        step = dataclasses.replace(chain.step(env_keys[t]),
                                   n_act=to_torch(jax.random.normal(k_act, (n, a))))
        if loop_cfg.use_hierarchical:
            # the fresh goals: categorical(fold_in(k_act, 17), logits)
            step.g_goal = to_torch(jax.random.gumbel(
                jax.random.fold_in(k_act, 17), (n, loop_cfg.hierarchical.num_goals)))
        samples = []
        if t % every == every - 1 and sizes[t] >= sac_cfg.learning_starts:
            samples = update_event_draws(k_update, sizes[t], sac_cfg, loop_cfg, demo_size)
        out.append(IterDraws(step=step, samples=samples))
    return out


def update_event_draws(key, size: int, sac_cfg, loop_cfg, demo_size: int = 0
                       ) -> list[SampleDraws]:
    """The ``SampleDraws`` of one update event that splits from ``key`` over
    a buffer holding ``size`` rows."""
    a, b = loop_cfg.action_dim, sac_cfg.batch_size
    n_demo = int(round(b * loop_cfg.demo_fraction)) if loop_cfg.demo_fraction > 0 else 0
    samples = []
    for _ in range(loop_cfg.updates_per_step):
        k_s, k_d, k_u, key = jax.random.split(key, 4)
        samples.append(SampleDraws(
            idx=sample_idx(k_s, b - n_demo, size),
            idx_demo=sample_idx(k_d, n_demo, demo_size) if n_demo else None,
            update=update_draws(k_u, b, a),
        ))
    return samples


def hoisted_iteration_draws(chain: KeyChain, key, env_keys, sizes, sac_cfg, loop_cfg,
                            demo_size: int = 0, rank: int | None = None) -> list[IterDraws]:
    """``iteration_draws`` for the reference's hoisted chunk path: per chunk of
    K steps, ``split(key, 3)`` (after ``fold_in(key, rank)`` with ``rank``),
    the K action keys from the first part, the chunk's update event, on its
    last step, from the second."""
    n, a, k_int = loop_cfg.num_envs, loop_cfg.action_dim, loop_cfg.update_interval
    out = []
    for c in range(0, loop_cfg.rollout_steps, k_int):
        (k_act_all, k_sample_update, _), key = rank_keys(key, rank, 3)
        for j, k_act in enumerate(jax.random.split(k_act_all, k_int)):
            t = c + j
            step = dataclasses.replace(chain.step(env_keys[t]),
                                       n_act=to_torch(jax.random.normal(k_act, (n, a))))
            samples = []
            if j == k_int - 1 and sizes[t] >= sac_cfg.learning_starts:
                samples = update_event_draws(k_sample_update, sizes[t], sac_cfg, loop_cfg,
                                             demo_size)
            out.append(IterDraws(step=step, samples=samples))
    return out


def ensemble_draws(chain: KeyChain, key, env_keys, sizes, actor: str, cfg, n: int, steps: int,
                   updates: int, rank: int | None = None) -> tuple[list, object]:
    """Every draw of one JAX ``make_ensemble_iteration`` call of ``n`` envs
    and ``steps`` steps (for data-parallel rank ``rank``), from the carry's
    key, the envs' keys before each step and the replay's size after each
    step's write; and the carry's key after the rollout (PPO's epochs draw
    from it, alike on every rank)."""
    from tvc_ai_torch.agents.ensemble import EnsembleStepDraws, TD3Draws

    gate = max(cfg.sac.learning_starts, cfg.sac.batch_size)
    b_sac, b_td3, act = cfg.sac.batch_size, cfg.td3.batch_size, 2
    out = []
    for t in range(steps):
        # the ensemble's chain moves on by split(key, 1) with or without ranks
        step_key = key if rank is None else jax.random.fold_in(key, rank)
        k_act, _, k_u1, _, k_u2, _ = jax.random.split(step_key, 6)
        (key,) = jax.random.split(key, 1)
        if actor == "ensemble":
            n_act = torch.stack([to_torch(jax.random.normal(k, (n, act)))
                                 for k in jax.random.split(k_act, 3)])
        else:
            n_act = to_torch(jax.random.normal(k_act, (n, act)))
        sac_draws, td3_draws = [], []
        if sizes[t] >= gate:
            k = k_u1
            for _ in range(updates):
                k_s, k_u, k = jax.random.split(k, 3)
                sac_draws.append(SampleDraws(idx=sample_idx(k_s, b_sac, sizes[t]),
                                             update=update_draws(k_u, b_sac, act)))
            k = k_u2
            for _ in range(updates):
                k_s, k_u, k = jax.random.split(k, 3)
                td3_draws.append(TD3Draws(idx=sample_idx(k_s, b_td3, sizes[t]),
                                          noise=to_torch(jax.random.normal(k_u, (b_td3, act)))))
        out.append(EnsembleStepDraws(step=dataclasses.replace(chain.step(env_keys[t]),
                                                              n_act=n_act),
                                     sac=sac_draws, td3=td3_draws))
    return out, key


def permutations(key, rows: int, epochs: int) -> list[torch.Tensor]:
    """The per-epoch permutations the reference draws from ``key``."""
    out = []
    for _ in range(epochs):
        key, k_perm, _ = jax.random.split(key, 3)
        out.append(to_torch(jax.random.permutation(k_perm, rows)).to(torch.int64))
    return out


def record_env_keys(fn, num_envs: int):
    """Run ``fn()`` (which must build its JAX iteration inside: the
    reference vmaps ``step_autoreset`` when it builds one) with the env keys
    each ``step_autoreset`` receives recorded, in env order; returns (fn's
    result, keys (steps, num_envs, 2))."""
    keys, original = [], j_env.step_autoreset

    def recording(state, action, params):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), state.key, ordered=True)
        return original(state, action, params)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_env, "step_autoreset", recording)
        out = fn()
        jax.effects_barrier()
    return out, np.stack(keys).reshape(-1, num_envs, 2)


def assert_state_close(t_state, j_state, atol=5e-5, rtol=5e-4, what=""):
    """Every field of a port EnvState against a JAX EnvState."""
    j = np_tree(j_state)
    for name in ("pos", "quat", "vel", "omega"):
        np.testing.assert_allclose(
            getattr(t_state.body, name).numpy(), getattr(j.body, name),
            atol=atol, rtol=rtol, err_msg=f"{what} body.{name}",
        )
    for name in ("mass", "thrust_scale", "cg_offset", "wind", "sensor_noise_std",
                 "progress_rate"):
        np.testing.assert_allclose(
            getattr(t_state.dr, name).numpy(), getattr(j.dr, name),
            atol=1e-6, rtol=1e-6, err_msg=f"{what} dr.{name}",
        )
    for name in ("fuel", "prev_action", "trim"):
        np.testing.assert_allclose(
            getattr(t_state, name).numpy(), getattr(j, name),
            atol=atol, rtol=rtol, err_msg=f"{what} {name}",
        )
    np.testing.assert_allclose(
        t_state.reward_window.numpy(), j.reward_window, atol=1e-3, rtol=1e-3,
        err_msg=f"{what} reward_window",
    )
    for name in ("step_count", "phase", "mission_success", "success_count",
                 "has_prev_action", "reward_window_len"):
        np.testing.assert_array_equal(
            getattr(t_state, name).numpy(), getattr(j, name), err_msg=f"{what} {name}"
        )
    if j.prev_imu is None:
        assert t_state.prev_imu is None, f"{what} prev_imu"
    else:
        np.testing.assert_allclose(t_state.prev_imu.numpy(), j.prev_imu, atol=atol, rtol=rtol,
                                   err_msg=f"{what} prev_imu")


OBS = dict(atol=5e-5, rtol=5e-4)
REWARD = dict(atol=1e-3, rtol=1e-3)


def run_env_parity(jp: EnvParams, batched: bool, seed: int, n: int = 64, steps: int = 16,
                   what: str = "") -> dict:
    """Both packages from the same reset, then ``steps`` free-running steps
    of seeded random actions on the replayed draws: the production route
    (K1's wrapper against JAX's Pallas kernel in interpret mode) or the plain
    one (``step_autoreset`` against ``vmap(step_autoreset)``). Every step's
    obs, reward, flags, next policy obs and state are held at the env bars
    (obs 5e-5 / 5e-4, reward 1e-3, flags exact, ``dr`` 1e-6). With sensor
    dropout on, both sides must hold the previous reading exactly where the
    draw says drop. Returns the counts of episode ends, dropped readings and
    first-success steps."""
    tp = env_params_from_numpy(jp)
    chain = KeyChain(jp)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    j_state, j_obs = jax.vmap(j_env.reset, in_axes=(0, None))(keys, jp)
    t_state, t_obs = t_env.reset(tp, n, device="cpu", draws=chain.reset(keys))
    np.testing.assert_allclose(t_obs.numpy(), np.asarray(j_obs), err_msg=what, **OBS)

    if batched:
        j_fn = jax.jit(lambda s, a: j_env.batched_step_autoreset(
            s, a, jp, use_pallas=True, block_envs=n, interpret=True))
    else:
        j_fn = jax.jit(jax.vmap(lambda s, a: j_env.step_autoreset(s, a, jp)))
    t_fn = t_env.batched_step_autoreset if batched else t_env.step_autoreset

    rng = np.random.default_rng(seed)
    counts = dict(dones=0, drops=0, first_successes=0)
    for t in range(steps):
        actions = rng.uniform(-1.0, 1.0, size=(n, 2)).astype(np.float32)
        d = chain.step(j_state.key)
        j_prev, t_prev = j_state, t_state
        j_state, j_out, j_next = j_fn(j_state, jnp.asarray(actions))
        t_state, t_out, t_next = t_fn(t_state, torch.from_numpy(actions), tp, n_imu=d.n_imu,
                                      reset_draws=d.reset, u_drop=d.u_drop)
        at = f"{what} step {t}"
        np.testing.assert_allclose(t_out.obs.numpy(), np.asarray(j_out.obs), err_msg=at, **OBS)
        np.testing.assert_allclose(t_out.reward.numpy(), np.asarray(j_out.reward), err_msg=at,
                                   **REWARD)
        for flag in ("terminated", "truncated", "mission_success", "crashed"):
            np.testing.assert_array_equal(getattr(t_out, flag).numpy(),
                                          np.asarray(getattr(j_out, flag)), err_msg=f"{at} {flag}")
        np.testing.assert_allclose(t_next.numpy(), np.asarray(j_next), err_msg=at, **OBS)
        assert_state_close(t_state, j_state, what=at)
        if d.u_drop is not None:
            drop = (d.u_drop < tp.randomization.sensor_dropout_prob).numpy()
            np.testing.assert_array_equal(t_out.obs[:, :7].numpy()[drop],
                                          t_prev.prev_imu.numpy()[drop], err_msg=at)
            np.testing.assert_array_equal(np.asarray(j_out.obs)[drop, :7],
                                          np.asarray(j_prev.prev_imu)[drop], err_msg=at)
            counts["drops"] += int(drop.sum())
        counts["dones"] += int((t_out.terminated | t_out.truncated).sum())
        counts["first_successes"] += int((t_out.mission_success & ~t_prev.mission_success).sum())
    return counts


# a success window that random actions reach within a few steps, so the
# first-success payout fires beside truncations and crashes
LOOSE_SUCCESS = dict(max_tilt_angle=0.15, max_angular_velocity=2.0, max_horizontal_velocity=2.0,
                     max_vertical_velocity=3.0, min_altitude=0.2, max_altitude=5.0,
                     success_duration=3)
EVERY_OPTION = dict(
    randomization=dict(enabled=True, sensor_noise_enabled=True, sensor_noise_uniform=True,
                       progress_rate_randomized=True, progress_rate_min=0.5,
                       progress_rate_max=2.0, feasible_only=True, feasible_tries=8,
                       dr_mixture_enabled=True, dr_prob=0.6, sensor_dropout_enabled=True,
                       sensor_dropout_prob=0.3, actuator_delay=True),
    reward=dict(survival_normalized_success=True, survival_success_scale=2.0,
                equilibrium_relative_shaping=True),
    success=LOOSE_SUCCESS, drift_obs_enabled=True,
)
# each robust-training option alone (with the domain draw where it acts on
# it), and all of them together
OPTION_CASES = {
    "feasible_only": dict(randomization=dict(enabled=True, feasible_only=True,
                                             feasible_tries=3)),
    "dr_mixture": dict(randomization=dict(enabled=True, dr_mixture_enabled=True, dr_prob=0.5)),
    "sensor_dropout": dict(randomization=dict(sensor_dropout_enabled=True,
                                              sensor_dropout_prob=0.3)),
    "actuator_delay": dict(randomization=dict(actuator_delay=True, init_tilt_max=0.2)),
    "survival_normalized_success": dict(
        reward=dict(survival_normalized_success=True, survival_success_scale=2.0),
        success=LOOSE_SUCCESS),
    "equilibrium_relative_shaping": dict(randomization=dict(enabled=True),
                                         reward=dict(equilibrium_relative_shaping=True)),
    "every_option": EVERY_OPTION,
}


def option_params(case: str | dict, max_episode_steps: int = 8) -> EnvParams:
    """The JAX ``EnvParams`` of an ``OPTION_CASES`` entry (or such a dict)."""
    kw = dict(OPTION_CASES[case] if isinstance(case, str) else case)
    return EnvParams(
        randomization=RandomizationConfig(**kw.pop("randomization", {})),
        reward=RewardConfig(**kw.pop("reward", {})),
        success=SuccessConfig(**kw.pop("success", {})),
        max_episode_steps=max_episode_steps, **kw,
    )


RESET_CASES = {
    "dr_noise": dict(enabled=True, sensor_noise_enabled=True),
    "dropout_noise": dict(sensor_noise_enabled=True, sensor_dropout_enabled=True,
                          sensor_dropout_prob=0.3),
    "feasible_mixture": dict(enabled=True, sensor_noise_enabled=True, feasible_only=True,
                             feasible_tries=3, dr_mixture_enabled=True, dr_prob=0.5),
    "dr_noise_init": dict(enabled=True, sensor_noise_enabled=True,
                          init_tilt_max=0.2, init_omega_max=0.3, init_pos_jitter=0.1),
    "nominal": dict(),
    "noise_uniform_progress": dict(sensor_noise_enabled=True, sensor_noise_uniform=True,
                                   progress_rate_randomized=True,
                                   progress_rate_min=0.5, progress_rate_max=2.0),
}


@pytest.mark.parametrize("case", sorted(RESET_CASES))
def test_reset_replayed_draws_match_jax(case):
    """The replayed draws reproduce JAX's reset exactly (obs and every field)."""
    jp = EnvParams(randomization=RandomizationConfig(**RESET_CASES[case]))
    tp = env_params_from_numpy(jp)
    n = 32
    keys = jax.random.split(jax.random.PRNGKey(3), n)
    j_state, j_obs = jax.vmap(j_env.reset, in_axes=(0, None))(keys, jp)
    t_state, t_obs = t_env.reset(tp, n, device="cpu", draws=KeyChain(jp).reset(keys))
    np.testing.assert_allclose(t_obs.numpy(), np.asarray(j_obs), atol=5e-6, rtol=5e-6)
    assert_state_close(t_state, j_state, atol=5e-6, rtol=5e-6, what=case)


def test_env_params_round_trip():
    jp = EnvParams(randomization=RandomizationConfig(enabled=True, wind_max=jnp.float32(2.5)),
                   max_episode_steps=8, trim_obs_enabled=True)
    tp = env_params_from_numpy(jp)
    assert tp.max_episode_steps == 8 and tp.trim_obs_enabled
    assert tp.randomization.enabled and tp.randomization.wind_max == 2.5
    assert tp.rocket.thrust_offset == (0.0, 0.0, -0.5)
    assert tp.init_pos == (0.0, 0.0, 1.0)
    assert tp.rocket.substeps == 4 and tp.rocket.double_gravity is True


def test_sample_idx_replays_replay_sample():
    """The replayed rows are the rows ``replay.sample`` returns, at several fills."""
    buf = j_replay.ReplayBuffer.create(64, {"x": jnp.zeros(())})
    buf = buf.replace(data={"x": jnp.arange(64, dtype=jnp.float32)})
    for size, seed in ((0, 1), (1, 2), (37, 3), (64, 4)):
        key = jax.random.PRNGKey(seed)
        rows = j_replay.sample(buf.replace(size=jnp.int32(size)), key, 16)["x"]
        np.testing.assert_array_equal(sample_idx(key, 16, size).numpy(), np.asarray(rows))


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_step_replayed_draws_match_jax(case):
    """With each option on, the replayed draws reproduce JAX's reset and one
    ``step_autoreset`` (every env truncates, so the autoreset's draws are
    all used) on the plain routes, at the env bars."""
    jp = option_params(case, max_episode_steps=1)
    tp = env_params_from_numpy(jp)
    n = 32
    chain = KeyChain(jp)
    keys = jax.random.split(jax.random.PRNGKey(4), n)
    j_state, j_obs = jax.vmap(j_env.reset, in_axes=(0, None))(keys, jp)
    t_state, t_obs = t_env.reset(tp, n, device="cpu", draws=chain.reset(keys))
    np.testing.assert_allclose(t_obs.numpy(), np.asarray(j_obs), atol=5e-6, rtol=5e-6)
    assert_state_close(t_state, j_state, atol=5e-6, rtol=5e-6, what=case)
    actions = np.random.default_rng(4).uniform(-1.0, 1.0, size=(n, 2)).astype(np.float32)
    d = chain.step(j_state.key)
    rnd = jp.randomization
    assert (d.n_imu is not None) == rnd.sensor_noise_enabled
    assert (d.u_drop is not None) == rnd.sensor_dropout_enabled
    assert (d.reset.u_feas is not None) == (rnd.enabled and rnd.feasible_only)
    assert (d.reset.n_dr is not None) == (rnd.enabled and not rnd.feasible_only)
    j_state, j_out, j_next = jax.vmap(lambda s, a: j_env.step_autoreset(s, a, jp))(
        j_state, jnp.asarray(actions))
    t_state, t_out, t_next = t_env.step_autoreset(t_state, torch.from_numpy(actions), tp,
                                                  n_imu=d.n_imu, reset_draws=d.reset,
                                                  u_drop=d.u_drop)
    np.testing.assert_allclose(t_out.obs.numpy(), np.asarray(j_out.obs), **OBS)
    np.testing.assert_allclose(t_out.reward.numpy(), np.asarray(j_out.reward), **REWARD)
    np.testing.assert_array_equal(t_out.truncated.numpy(), np.asarray(j_out.truncated))
    assert bool(t_out.truncated.all())
    np.testing.assert_allclose(t_next.numpy(), np.asarray(j_next), atol=5e-6, rtol=5e-6)
    assert_state_close(t_state, j_state, atol=5e-6, rtol=5e-6, what=case)


DATA_AXIS = "data"


def shard_of(tree, rank: int):
    """Rank ``rank``'s part of a JAX tree laid out over a mesh, as numpy: a
    sharded leaf's slice, a replicated leaf whole; other leaves as they are."""
    return jax.tree.map(
        lambda x: np.asarray(x.addressable_shards[rank].data) if isinstance(x, jax.Array) else x,
        tree)


def record_env_keys_sharded(fn, world: int, vmapped: bool):
    """Run ``fn()`` (which must build or first call its JAX program inside)
    with the env keys each rank's step receives recorded; returns (fn's
    result, {rank: keys (steps, n, 2)}). ``vmapped``: the program vmaps
    ``rocket_env.step_autoreset`` (PPO, the ensemble), whose keys arrive one
    batch per step through a ``custom_vmap`` tap; otherwise it calls
    ``batched_step_autoreset`` on the whole batch. A trace outside the mesh
    (an abstract twin) records nothing."""
    from jax import custom_batching

    keys = {r: [] for r in range(world)}

    def store(k, r):
        keys[int(r)].append(np.asarray(k))

    @custom_batching.custom_vmap
    def tap(k, r):
        jax.debug.callback(lambda k, r: store(np.asarray(k)[None], r), k, r)
        return k

    @tap.def_vmap
    def _tap_batched(axis_size, in_batched, k, r):
        jax.debug.callback(store, k, r)
        return k, in_batched[0]

    def axis_index():
        try:
            return jax.lax.axis_index(DATA_AXIS)
        except NameError:   # traced outside shard_map
            return None

    name = "step_autoreset" if vmapped else "batched_step_autoreset"
    original = getattr(j_env, name)

    def recording(states, *args, **kw):
        r = axis_index()
        if r is not None:
            if vmapped:
                tap(states.key, r)
            else:
                jax.debug.callback(store, states.key, r)
        return original(states, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_env, name, recording)
        out = fn()
        jax.effects_barrier()
    return out, {r: np.stack(v) for r, v in keys.items()}


def jax_schedule(sched):
    """A port ``LQRSchedule`` (tensors) as the JAX package's (jnp arrays)."""
    from tvc_ai_tpu.training import demos as j_demos

    fields = j_demos.LQRSchedule._fields
    return j_demos.LQRSchedule(**{f: None if getattr(sched, f) is None
                                  else jnp.asarray(getattr(sched, f).numpy()) for f in fields})


def jax_body(body):
    """A port ``RigidBodyState`` (CPU tensors) as the JAX package's."""
    from tvc_ai_tpu.physics.types import RigidBodyState as JBody

    return JBody(**{f: jnp.asarray(getattr(body, f).numpy())
                    for f in ("pos", "quat", "vel", "omega")})


def random_bodies(rng, n: int, tilt: float = 0.15, z: float = 0.5):
    """(numpy dict, port RigidBodyState) of n random near-upright bodies."""
    from tvc_ai_torch.physics.types import RigidBodyState as TBody

    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = rng.uniform(0.0, tilt, size=(n, 1))
    body = dict(pos=rng.normal(0.0, 0.3, size=(n, 3)) + [0.0, 0.0, z],
                quat=np.concatenate([axis * np.sin(half), np.cos(half)], axis=1),
                vel=rng.normal(0.0, 0.5, size=(n, 3)), omega=rng.normal(0.0, 0.5, size=(n, 3)))
    body = {k: v.astype(np.float32) for k, v in body.items()}
    return body, TBody(**{k: torch.from_numpy(v) for k, v in body.items()})


@contextlib.contextmanager
def recording_batched_keys():
    """Within the block, the env keys of every ``rocket_env.batched_step_autoreset``
    call a JAX program traced in it makes are appended (in order) to the
    yielded list, also on the program's later calls: clear it between calls."""
    keys, original = [], j_env.batched_step_autoreset

    def recording(states, actions, params, **kw):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), states.key, ordered=True)
        return original(states, actions, params, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_env, "batched_step_autoreset", recording)
        yield keys
        jax.effects_barrier()


def normal_chain_noise(key, steps: int, n: int) -> torch.Tensor:
    """The controller's IMU noise ``cem.rollout_score(.., key)`` draws with
    ``obs_noise_std > 0``: per step ``k, kq, kw = split(k, 3)``, then
    normal(kq, (n, 4)) and normal(kw, (n, 3)); returns (steps, n, 7)."""
    out = []
    for _ in range(steps):
        key, kq, kw = jax.random.split(key, 3)
        out.append(np.concatenate([np.asarray(jax.random.normal(kq, (n, 4))),
                                   np.asarray(jax.random.normal(kw, (n, 3)))], axis=-1))
    return torch.from_numpy(np.stack(out))


def cem_draws(key, cfg, draws: int):
    """The draws ``cem.refine_per_draw(key, ..)`` consumes: per generation
    ``key, k_noise, k_obs = split(key, 3)``, normal(k_noise, (D, P, 15)) and,
    with obs noise, ``normal_chain_noise(k_obs, ..)``."""
    from tvc_ai_torch.training.cem import THETA_DIM, CEMDraws

    noise, obs = [], []
    for _ in range(cfg.generations):
        key, k_noise, k_obs = jax.random.split(key, 3)
        noise.append(np.asarray(jax.random.normal(k_noise, (draws, cfg.pop, THETA_DIM))))
        if cfg.obs_noise_std > 0.0:
            obs.append(normal_chain_noise(k_obs, cfg.horizon, draws * cfg.pop))
    return CEMDraws(noise=torch.from_numpy(np.stack(noise)),
                    obs_noise=torch.stack(obs) if obs else None)


def verify_params(jp: EnvParams) -> EnvParams:
    """The verification's env: randomization and noise off."""
    return jp.replace(randomization=jp.randomization.replace(
        enabled=False, sensor_noise_enabled=False, sensor_noise_uniform=False,
        progress_rate_randomized=False))


def verify_draws(jp: EnvParams, rows: int, key=None):
    """The draws of ``_verify_rollouts(.., key)``: the reset's of
    ``split(key, rows)`` and each row's axis angle ``uniform(k, (), 0, 2π)``."""
    keys = jax.random.split(jax.random.PRNGKey(0) if key is None else key, rows)
    ang = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.0, maxval=2.0 * jnp.pi))(keys)
    return KeyChain(verify_params(jp)).reset(keys), torch.from_numpy(np.array(ang)), keys


def jax_verify_start(jp, mass_r, tsc_r, keys, tilt0):
    """The reference's ``_verify_rollouts`` start (reset, the row's plant, tilt)."""
    n = mass_r.shape[0]
    states, _ = jax.vmap(j_env.reset, in_axes=(0, None))(keys, jp)
    zeros3 = jnp.zeros((n, 3), jnp.float32)
    states = states.replace(dr=states.dr.replace(mass=mass_r, thrust_scale=tsc_r,
                                                 cg_offset=zeros3, wind=zeros3))
    ang = jax.vmap(lambda k: jax.random.uniform(k, (), minval=0.0, maxval=2.0 * jnp.pi))(keys)
    axis = jnp.stack([jnp.cos(ang), jnp.sin(ang), jnp.zeros_like(ang)], -1)
    half = jnp.float32(tilt0 / 2.0)
    dq = jnp.concatenate([axis * jnp.sin(half), jnp.full((n, 1), jnp.cos(half))], -1)
    return states.replace(body=states.body.replace(
        quat=jax.vmap(j_quat.multiply)(dq, states.body.quat)))
