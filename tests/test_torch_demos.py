"""LQR demonstration seeding (``tvc_ai_torch/training/demos.py`` and
``Trainer``'s ``training.demo_seeding``) against the JAX package (CPU).

- ``design_lqr``: the gains, ``z_eq`` and the trim slopes at rtol 1e-4 of
  the JAX function's, both synthesized from their own step maps on the CPU.
  The standing equilibria come from a 40-step nested bisection whose last
  sign decisions sit on float32 rounding of a residual near zero, so a
  decision may go the other way in the port: the equilibrium tilt and gimbal
  are held within 1e-6 rad (measured: 1e-8 at d = 0.02), which moves a trim
  slope by at most 5e-5 relative.
- ``_dlqr``: the same float64 iteration (equal gains on a stabilizable plant)
  and the zero gain of a diverging one (the counterpart of
  ``tests/test_training_subsystems.py::test_dlqr_divergence_returns_zero_gain``).
- ``lqr_action`` at 1e-5 on random body states, blind and told the CG offset.
- ``generate_demonstrations`` through the plain route against the JAX
  rollout (``use_pallas=False``) on the replayed draws (the env keys recorded
  as the JAX scan runs), history 1 and 2, at the env bars (obs 5e-5 / 5e-4,
  reward 1e-3, done exact), the statistics equal.
- ``seed_replay_buffer``'s rows exactly the JAX function's, the ring wrapping.
- The trainer case of ``tests/test_trainer.py::test_demo_seeding_fills_replay``:
  the replay holds the demos in the policy's obs space (drift channels
  included) before the first iteration, the persistent demo buffer equals
  the ring's seeded region, the mixed batches train, and a resume restores
  both buffers bit for bit; at a world above 1 demo seeding is refused.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import KeyChain, np_tree
from test_torch_trainer import tiny_cfg
from tvc_ai_torch.agents import replay as t_replay
from tvc_ai_torch.convert import env_params_from_numpy
from tvc_ai_torch.training import demos as t_demos
from tvc_ai_torch.training.trainer import Trainer, check_supported
from tvc_ai_torch.utils.checkpoint import diff_states
from tvc_ai_tpu.agents import replay as j_replay
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig
from tvc_ai_tpu.training import demos as j_demos

torch.set_num_threads(1)
OBS = dict(atol=5e-5, rtol=5e-4)
REWARD = dict(atol=1e-3, rtol=1e-3)
# demos as training seeds them: the CG offset drawn, sensor noise on, the
# drift channels observed, nominal starts; 6-step episodes so that resets fire
DEMO_PARAMS = EnvParams(
    randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True,
                                      cg_offset_max=0.02, mass_variation=0.0,
                                      thrust_variation=0.0, wind_max=0.0),
    drift_obs_enabled=True, max_episode_steps=6)


def port_design(d) -> t_demos.LQRDesign:
    """A JAX ``LQRDesign`` as the port's (float32 numpy fields)."""
    return t_demos.LQRDesign(*(np.asarray(x, np.float32) for x in d))


@pytest.fixture(scope="module")
def designs():
    jp = EnvParams()
    return j_demos.design_lqr(jp), t_demos.design_lqr(env_params_from_numpy(jp))


def test_design_lqr_matches_jax(designs):
    j_design, t_design = designs
    for name in t_demos.LQRDesign._fields:
        got, want = np.asarray(getattr(t_design, name)), np.asarray(getattr(j_design, name))
        assert got.dtype == np.float32, name
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7, err_msg=name)
    assert np.all(np.isfinite(t_design.gain)) and abs(float(t_design.gain[2])) > 1.0
    # the two planes mirror each other
    np.testing.assert_allclose(t_design.gain_pitch[[0, 3]], t_design.gain[[0, 3]], rtol=1e-6)
    assert float(t_design.trim_slope) == pytest.approx(-float(t_design.trim_slope_pitch))


@pytest.mark.parametrize("pitch", [False, True])
def test_solve_equilibrium_matches_jax(pitch):
    rp_j = EnvParams().rocket
    rp_t = env_params_from_numpy(EnvParams()).rocket
    # d = 0 enters design_lqr's test; d = 0.02 gives the trim slope
    got = t_demos.solve_equilibrium(rp_t, 0.02, pitch)
    want = j_demos.solve_equilibrium(rp_j, 0.02, pitch)
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-6, rtol=0)
    assert got[2] == want[2]   # the depth is closed form
    assert abs(got[0]) == pytest.approx(t_demos.equilibrium_tilt(
        env_params_from_numpy(EnvParams()), 0.02))


def test_dlqr_matches_jax_and_returns_zero_gain_on_divergence():
    k = t_demos._dlqr(np.diag([2.0, 1.5]), np.zeros((2, 1)), np.eye(2), np.eye(1))
    assert k.shape == (1, 2) and np.all(k == 0.0)
    rng = np.random.default_rng(0)
    a = np.eye(4) + 0.05 * rng.normal(size=(4, 4))
    b = rng.normal(size=(4, 1))
    q, r = np.diag([1.0, 2.0, 3.0, 4.0]), np.array([[0.5]])
    got = t_demos._dlqr(a, b, q, r)
    np.testing.assert_array_equal(got, j_demos._dlqr(a, b, q, r))
    assert np.abs(got).max() > 0.0


@pytest.mark.parametrize("privileged", [False, True])
def test_lqr_action_matches_jax(designs, privileged):
    from tvc_ai_tpu.physics.types import RigidBodyState as JBody
    from tvc_ai_torch.physics.types import RigidBodyState as TBody

    j_design = designs[0]
    rng = np.random.default_rng(1)
    n = 64
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = rng.uniform(0.0, 0.15, size=(n, 1))
    body = dict(pos=rng.normal(0.0, 0.3, size=(n, 3)) + [0.0, 0.0, 0.5],
                quat=np.concatenate([axis * np.sin(half), np.cos(half)], axis=1),
                vel=rng.normal(0.0, 0.5, size=(n, 3)), omega=rng.normal(0.0, 0.5, size=(n, 3)))
    body = {k: v.astype(np.float32) for k, v in body.items()}
    d = (rng.uniform(-0.04, 0.04, size=(n, 3)) * privileged).astype(np.float32)
    rp = EnvParams().rocket
    want = j_demos.lqr_action(JBody(**{k: jnp.asarray(v) for k, v in body.items()}), j_design,
                              jnp.asarray(d), rp)
    got = t_demos.lqr_action(TBody(**{k: torch.from_numpy(v) for k, v in body.items()}),
                             port_design(j_design), torch.from_numpy(d),
                             env_params_from_numpy(EnvParams()).rocket)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert 0 < int((got.abs() == 1.0).sum()) < got.numel()   # some saturate, not all


def _jax_demos(design, n: int, steps: int, history: int):
    """The JAX rollout with each step's env keys recorded (ordered)."""
    keys, original = [], j_env.batched_step_autoreset

    def recording(states, actions, params, **kw):
        jax.debug.callback(lambda k: keys.append(np.asarray(k)), states.key, ordered=True)
        return original(states, actions, params, **kw)

    key = jax.random.PRNGKey(3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_env, "batched_step_autoreset", recording)
        trans, stats = j_demos.generate_demonstrations(key, DEMO_PARAMS, design, n, steps,
                                                       history_len=history)
        jax.effects_barrier()
    return key, np_tree(trans), stats, np.stack(keys)


@pytest.mark.parametrize("history", [1, 2])
def test_generate_demonstrations_matches_jax(designs, history):
    n, steps = 16, 24
    key, want, want_stats, env_keys = _jax_demos(designs[0], n, steps, history)
    chain = KeyChain(DEMO_PARAMS)
    got, stats = t_demos.generate_demonstrations(
        env_params_from_numpy(DEMO_PARAMS), port_design(designs[0]), n, steps,
        history_len=history, device="cpu", reset_draws=chain.reset(jax.random.split(key, n)),
        step_draws=[chain.step(k) for k in env_keys])
    assert sorted(got) == sorted(want)
    for k in ("obs", "next_obs", "action"):
        assert got[k].shape == want[k].shape == (steps, n, *want[k].shape[2:]), k
        np.testing.assert_allclose(got[k].numpy(), want[k], **OBS, err_msg=k)
    np.testing.assert_allclose(got["reward"].numpy(), want["reward"], **REWARD)
    np.testing.assert_array_equal(got["done"].numpy(), want["done"])
    assert got["obs"].shape[-1] == 14 * history     # 10 + 4 drift channels
    assert stats == pytest.approx(want_stats)
    assert stats["demo_episodes"] >= n and stats["demo_transitions"] == n * steps


def test_seed_replay_buffer_rows_exact():
    rng = np.random.default_rng(2)
    steps, n, cap = 6, 8, 32   # 48 rows into 32: the ring wraps
    trans = {"obs": rng.normal(size=(steps, n, 14)), "action": rng.normal(size=(steps, n, 2)),
             "reward": rng.normal(size=(steps, n)), "next_obs": rng.normal(size=(steps, n, 14)),
             "done": (rng.uniform(size=(steps, n)) < 0.3)}
    trans = {k: v.astype(np.float32) for k, v in trans.items()}
    example = {k: np.asarray(v[0, 0]) for k, v in trans.items()}
    want = j_demos.seed_replay_buffer(
        j_replay.ReplayBuffer.create(cap, {k: jnp.asarray(v) for k, v in example.items()}),
        {k: jnp.asarray(v) for k, v in trans.items()})
    got = t_demos.seed_replay_buffer(
        t_replay.ReplayBuffer.create(cap, {k: torch.from_numpy(v) for k, v in example.items()},
                                     "cpu"),
        {k: torch.from_numpy(v) for k, v in trans.items()})
    assert (got.ptr, got.size) == (int(want.ptr), int(want.size)) == (16, 32)
    for k in trans:
        np.testing.assert_array_equal(got.data[k].numpy(), np.asarray(want.data[k]), err_msg=k)


def test_trainer_demo_seeding_fills_replay_and_resumes(tmp_path):
    cfg = tiny_cfg(tmp_path, total=256, extra=[
        "training.demo_seeding.enabled=true", "training.demo_seeding.envs=8",
        "training.demo_seeding.steps=32", "training.demo_seeding.cg_offset_max=0.02",
        "training.demo_seeding.fraction=0.25", "training.demo_seeding.bc_weight=2.5",
        "env.drift_observation.enabled=true", "hardware.mesh_devices=1"])
    t = Trainer(cfg, output_dir=tmp_path / "seeded", device="cpu")
    assert t.carry.buffer.size == 8 * 32
    obs = t.carry.buffer.data["obs"][: 8 * 32]
    assert obs.shape[-1] == 14                        # 10 base + 4 drift channels
    assert float(obs[:, -4:].abs().max()) > 1e-4      # the demos moved the vehicle
    assert t.carry.demo_buffer.size == t.carry.demo_buffer.capacity == 8 * 32
    assert torch.equal(t.carry.demo_buffer.data["obs"], obs)
    assert t.loop_cfg.demo_fraction == 0.25 and t.sac_cfg.bc_weight == 2.5
    assert t.demo_stats["demo_transitions"] == 256.0
    demo_before = {k: v.clone() for k, v in t.carry.demo_buffer.data.items()}
    result = t.train()
    assert result["env_steps"] >= 256
    assert all(torch.equal(t.carry.demo_buffer.data[k], v) for k, v in demo_before.items())
    header = (tmp_path / "seeded" / "metrics.csv").read_text().splitlines()[0].split(",")
    assert {"demo/demo_success_rate", "bc_loss"} <= set(header)
    t2 = Trainer(cfg, output_dir=tmp_path / "resumed", resume=tmp_path / "seeded" / "checkpoints",
                 device="cpu")
    assert diff_states(t2.carry.demo_buffer, t.carry.demo_buffer) == []
    assert diff_states(t2.carry.buffer, t.carry.buffer) == []
    assert not hasattr(t2, "demo_stats")   # restored, not generated again
    t2.logger.close()


def test_demo_seeding_refused_where_the_reference_refuses(tmp_path):
    cfg = tiny_cfg(tmp_path, extra=["training.demo_seeding.enabled=true"])
    check_supported(cfg, 1)
    with pytest.raises(ValueError, match="single-device"):
        check_supported(cfg, 2)
    cfg.hierarchical_rl.enabled = True
    with pytest.raises(ValueError, match="hierarchical"):
        check_supported(cfg, 1)
    warm = tiny_cfg(tmp_path, extra=["training.warm_start_actor=student.msgpack"])
    with pytest.raises(ValueError, match="single-device"):
        check_supported(warm, 2)
    check_supported(warm, 1)   # ported: the Trainer reads the port's own student file
    # a flax msgpack file is read, and one that holds no SACState is refused
    with pytest.raises(ValueError, match="no actor_params"):
        (tmp_path / "student.msgpack").write_bytes(b"\x81\xa5state\x80")
        Trainer(tiny_cfg(tmp_path, extra=[
            f"training.warm_start_actor={tmp_path / 'student.msgpack'}"]),
            output_dir=tmp_path / "w", device="cpu")
    cut = tiny_cfg(tmp_path, extra=["training.demo_seeding.enabled=true",
                                    "training.demo_seeding.envs=3"])
    with pytest.raises(ValueError, match="must divide"):
        Trainer(cut, output_dir=tmp_path / "x", device="cpu")
