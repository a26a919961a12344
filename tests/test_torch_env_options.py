"""The robust-training env options of tvc_ai_torch against the JAX package (CPU).

Feasible-only domain draws, the easy/hard mixture, sensor dropout, actuator
delay, the survival-normalized success payout and equilibrium-relative
shaping: each alone and all together, free-running 16 steps from the same
reset on the replayed draws (``test_torch_parity_utils.run_env_parity``):
through K1's wrapper against JAX's Pallas route in interpret mode, and all
together through the plain routes too. Then the domain draw on a batch large
enough that the feasibility fallback and the mixture gate both fire, the
payout on a forced first-success step, a JAX state with ``prev_imu`` carried
across, and the reset's seeding of the held reading. Bars: obs 5e-5 / 5e-4,
reward 1e-3, flags and branch selections exact, ``dr`` 1e-6.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import (
    LOOSE_SUCCESS,
    OBS,
    OPTION_CASES,
    REWARD,
    KeyChain,
    _domain_draws_one,
    assert_state_close,
    np_tree,
    option_params,
    run_env_parity,
    to_torch,
)
from tvc_ai_torch.convert import env_params_from_numpy, env_state_from_numpy
from tvc_ai_torch.env import randomization as t_rand
from tvc_ai_torch.env import rocket_env as t_env
from tvc_ai_torch.env import types as t_types
from tvc_ai_tpu.env import randomization as j_rand
from tvc_ai_tpu.env import rocket_env as j_env
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig
from tvc_ai_tpu.physics.types import RocketParams

torch.set_num_threads(1)
N, STEPS = 64, 16
DR = dict(atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("case", sorted(c for c in OPTION_CASES if c != "every_option"))
def test_option_alone_matches_jax(case):
    """One option on: K1's wrapper against JAX's Pallas route (interpret)."""
    counts = run_env_parity(option_params(case), batched=True, seed=41, n=N, steps=STEPS,
                            what=case)
    assert counts["dones"] >= N  # autoresets fired
    if case == "sensor_dropout":
        assert counts["drops"] > 0
    if case == "survival_normalized_success":
        assert counts["first_successes"] > 0


@pytest.mark.parametrize("batched", [True, False], ids=["k1_route", "plain_route"])
def test_every_option_matches_jax(batched):
    """Every option on (noise uniform, progress-rate DR and drift observation
    too), through K1's wrapper and through the plain ``step_autoreset``."""
    counts = run_env_parity(option_params("every_option"), batched, seed=42, n=N, steps=STEPS,
                            what="every_option")
    assert counts["dones"] >= N and counts["drops"] > 0 and counts["first_successes"] > 0


# name: (randomization, rocket)
DOMAIN_CASES = {
    "feasible": (dict(enabled=True, feasible_only=True, feasible_tries=2), {}),
    "feasible_mixture_dither": (
        dict(enabled=True, feasible_only=True, feasible_tries=2, dr_mixture_enabled=True,
             dr_prob=0.6, sensor_noise_enabled=True, sensor_noise_uniform=True,
             progress_rate_randomized=True, progress_rate_min=0.5, progress_rate_max=2.0),
        {}),
    # single gravity at a thrust near the weight: climb-away and pinned both occur
    "feasible_single_gravity": (dict(enabled=True, feasible_only=True, feasible_tries=2),
                                dict(double_gravity=False, thrust=18.0)),
    "mixture": (dict(enabled=True, dr_mixture_enabled=True, dr_prob=0.3), {}),
}


@pytest.mark.parametrize("case", sorted(DOMAIN_CASES))
def test_domain_draw_matches_jax(case):
    """``sample_domain_params`` on 4096 envs against JAX's on the replayed
    draws (``dr`` 1e-6), and ``feasible_draw_mask`` on the candidates
    exactly; the fallback (no feasible candidate: nominal plant, wind from
    candidate 0) and the mixture gate (easy: nominal plant, no wind) both
    fire and are checked row by row."""
    rnd_kw, rocket_kw = DOMAIN_CASES[case]
    jp = EnvParams(rocket=RocketParams(**rocket_kw),
                   randomization=RandomizationConfig(**rnd_kw))
    tp = env_params_from_numpy(jp)
    rocket, rnd = tp.rocket, tp.randomization
    n = 4096
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    ref = np_tree(jax.jit(jax.vmap(
        lambda k: j_rand.sample_domain_params(k, jp.rocket, jp.randomization)))(keys))
    draws = {k: to_torch(v) for k, v in
             jax.jit(jax.vmap(lambda k: _domain_draws_one(k, jp.randomization)))(keys).items()}
    got = t_rand.sample_domain_params(rocket, rnd, n, torch.device("cpu"), **draws)
    for f in dataclasses.fields(got):
        np.testing.assert_allclose(getattr(got, f.name).numpy(), getattr(ref, f.name),
                                   err_msg=f.name, **DR)
    u_mix = draws["u_dr"][:, 4]
    hard = (u_mix * 0.5 + 0.5 < rnd.dr_prob) if rnd.dr_mixture_enabled else torch.ones(n, dtype=bool)
    nominal_wind = torch.zeros(3)
    if rnd.feasible_only:
        u, nk = draws["u_feas"], draws["n_feas"]
        assert "n_dr" not in draws and u.shape == (n, 2, 4) and nk.shape == (n, 2, 3)
        mass_k = rocket.mass * (1.0 + u[..., 0] * rnd.mass_variation)
        thrust_k = 1.0 + torch.clamp(nk[..., 0] * rnd.thrust_variation,
                                     -2.0 * rnd.thrust_variation, 2.0 * rnd.thrust_variation)
        cg_k = torch.cat([u[..., 1:3], u[..., 3:] * 0.5], dim=-1) * rnd.cg_offset_max
        ok = t_rand.feasible_draw_mask(mass_k, thrust_k, cg_k, rocket, rnd.feasible_tilt_limit)
        j_ok = j_rand.feasible_draw_mask(jnp.asarray(mass_k.numpy()), jnp.asarray(thrust_k.numpy()),
                                         jnp.asarray(cg_k.numpy()), jp.rocket,
                                         jp.randomization.feasible_tilt_limit)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))
        none = ~ok.any(dim=1)
        second = ~ok[:, 0] & ok[:, 1]
        assert (none & hard).any() and (second & hard).any() and ok[:, 0].any(), case
        # the fallback keeps candidate 0's wind (the reference's quirk)
        wind0 = torch.clamp(nk[:, 0, 1:] * (rnd.wind_max * 0.5), -rnd.wind_max, rnd.wind_max)
        rows = none & hard
        assert torch.equal(got.mass[rows], torch.full((int(rows.sum()),), rocket.mass))
        assert torch.equal(got.cg_offset[rows], torch.zeros(int(rows.sum()), 3))
        assert torch.equal(got.wind[rows, :2], wind0[rows])
        # the first feasible candidate wins
        rows = second & hard
        assert torch.equal(got.mass[rows], mass_k[rows, 1])
        assert torch.equal(got.thrust_scale[rows], thrust_k[rows, 1])
    else:
        assert "u_feas" not in draws and draws["n_dr"].shape == (n, 3)
    if rnd.dr_mixture_enabled:
        easy = ~hard
        assert easy.any() and hard.any()
        assert torch.equal(got.mass[easy], torch.full((int(easy.sum()),), rocket.mass))
        assert torch.equal(got.thrust_scale[easy], torch.ones(int(easy.sum())))
        assert torch.equal(got.wind[easy], nominal_wind.expand(int(easy.sum()), 3))
        assert (got.wind[hard, :2] != 0.0).all()
    if rnd.sensor_noise_uniform:
        assert float(got.sensor_noise_std.std()) > 0.0   # the dither slots stay randomized


def test_survival_payout_on_forced_first_success():
    """States one step short of the success window's length: the step that
    completes it pays max(window mean, 0) × steps left × scale once, on top
    of the clipped per-step reward; the window mean includes this step's
    reward and divides by the fill clipped to [1, variance_window]. The next
    step pays nothing more."""
    success = dict(LOOSE_SUCCESS, success_duration=3)
    reward_on = dict(survival_normalized_success=True, survival_success_scale=2.0)
    params = {on: option_params({"success": success, "reward": reward_on if on else {}},
                                max_episode_steps=50) for on in (True, False)}
    n = 8
    keys = jax.random.split(jax.random.PRNGKey(9), n)
    j_state, _ = jax.vmap(j_env.reset, in_axes=(0, None))(keys, params[True])
    rng = np.random.default_rng(9)
    window = rng.uniform(-1.0, 5.0, size=(n, 10)).astype(np.float32)
    window[1] -= 20.0   # a negative mean: floored at 0
    j_state = j_state.replace(
        success_count=jnp.full((n,), 2, jnp.int32),
        reward_window=jnp.asarray(window),
        reward_window_len=jnp.asarray([0, 9, 1, 3, 9, 10, 15, 40], jnp.int32),
        step_count=jnp.asarray([0, 5, 10, 20, 30, 40, 48, 49], jnp.int32),
    )
    t_state = env_state_from_numpy(np_tree(j_state), device="cpu")
    actions = np.zeros((n, 2), np.float32)
    out, new = {}, {}
    for on, jp in params.items():
        j_new, j_out = jax.vmap(lambda s, a: j_env.step(s, a, jp))(j_state, jnp.asarray(actions))
        t_new, t_out = t_env.step(t_state, torch.from_numpy(actions), env_params_from_numpy(jp))
        np.testing.assert_allclose(t_out.reward.numpy(), np.asarray(j_out.reward), **REWARD)
        out[on], new[on] = t_out, t_new
    assert bool(out[True].mission_success.all()) and not bool(t_state.mission_success.any())
    fill = torch.clamp(new[True].reward_window_len.to(torch.float32), 1.0, 10.0)
    mean = new[True].reward_window.sum(dim=-1) / fill
    remaining = (50 - new[True].step_count).clamp(min=0).to(torch.float32)
    want = torch.clamp(mean, min=0.0) * remaining * 2.0
    paid = out[True].reward - out[False].reward
    torch.testing.assert_close(paid, want, rtol=1e-5, atol=1e-3)
    assert (want > 100.0).sum() >= 4 and float(want[1]) == 0.0 and float(want[7]) == 0.0
    assert float(out[False].reward.max()) <= 200.0 < float(out[True].reward.max())  # past the clip
    # the flag is set now: the next step pays nothing more
    again = {on: t_env.step(new[on], torch.from_numpy(actions), env_params_from_numpy(jp))[1]
             for on, jp in params.items()}
    torch.testing.assert_close(again[True].reward, again[False].reward, rtol=0.0, atol=0.0)


def test_env_state_from_numpy_carries_prev_imu():
    """A JAX state with sensor dropout on carries its held reading across,
    and both packages step on identically from there; without dropout the
    converted state holds none."""
    jp = option_params("every_option")
    tp = env_params_from_numpy(jp)
    chain = KeyChain(jp)
    keys = jax.random.split(jax.random.PRNGKey(6), 16)
    j_state, _ = jax.vmap(j_env.reset, in_axes=(0, None))(keys, jp)
    actions = jnp.full((16, 2), 0.3)
    j_step = jax.jit(jax.vmap(lambda s, a: j_env.step_autoreset(s, a, jp)))
    j_state, _, _ = j_step(j_state, actions)
    t_state = env_state_from_numpy(np_tree(j_state), device="cpu")
    assert t_state.prev_imu.shape == (16, 7)
    assert_state_close(t_state, j_state, atol=0.0, rtol=0.0)
    d = chain.step(j_state.key)
    j_state, j_out, _ = j_step(j_state, actions)
    t_state, t_out, _ = t_env.step_autoreset(t_state, torch.full((16, 2), 0.3), tp, n_imu=d.n_imu,
                                             reset_draws=d.reset, u_drop=d.u_drop)
    np.testing.assert_allclose(t_out.obs.numpy(), np.asarray(j_out.obs), **OBS)
    assert_state_close(t_state, j_state)
    plain, _ = jax.vmap(j_env.reset, in_axes=(0, None))(keys, EnvParams())
    assert plain.prev_imu is None
    assert env_state_from_numpy(np_tree(plain), device="cpu").prev_imu is None


def test_reset_seeds_prev_imu_and_draws_only_what_is_on():
    """Reset presents the first reading with no dropout and holds it as
    ``prev_imu``; at dropout probability 1 every later step presents that
    reading again. ``draw_reset`` draws the feasibility candidates only with
    ``feasible_only`` and randomization both on, and a state without a held
    reading refuses to step with dropout on."""
    rnd = t_types.RandomizationConfig(sensor_noise_enabled=True, sensor_dropout_enabled=True,
                                      sensor_dropout_prob=1.0, init_tilt_max=0.3)
    tp = t_types.EnvParams(randomization=rnd)
    g = torch.Generator().manual_seed(0)
    state, obs = t_env.reset(tp, 5, device="cpu", generator=g)
    first = obs[:, :7].clone()
    assert torch.equal(state.prev_imu, first)
    for _ in range(3):
        state, out = t_env.step(state, torch.rand((5, 2), generator=g) * 2 - 1, tp, generator=g)
        assert torch.equal(out.obs[:, :7], first) and torch.equal(state.prev_imu, first)
    with pytest.raises(ValueError, match="prev_imu"):
        t_env.step(dataclasses.replace(state, prev_imu=None), torch.zeros(5, 2), tp)
    assert t_env.reset(t_types.EnvParams(), 2, device="cpu")[0].prev_imu is None

    cpu = torch.device("cpu")
    feas = t_types.RandomizationConfig(feasible_only=True, feasible_tries=5)
    d = t_env.draw_reset(t_types.EnvParams(randomization=feas), 4, cpu, g)
    assert d.u_feas is None and d.n_feas is None and d.u_dr is None     # randomization off
    on = dataclasses.replace(feas, enabled=True)
    d = t_env.draw_reset(t_types.EnvParams(randomization=on), 4, cpu, g)
    assert d.u_feas.shape == (4, 5, 4) and d.n_feas.shape == (4, 5, 3) and d.n_dr is None
    assert float(d.u_feas.min()) >= -1.0 and float(d.u_feas.max()) < 1.0
    d = t_env.draw_reset(t_types.EnvParams(randomization=dataclasses.replace(
        on, feasible_only=False)), 4, cpu, g)
    assert d.u_feas is None and d.n_dr.shape == (4, 3)
