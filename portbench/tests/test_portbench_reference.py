"""The reference agrees with the port over whole chunks at small N on the
CPU, given the same draws and weights, in both configurations and both
traffic mixes (on the CPU the port's step kernel runs its plain version, so
they agree to the bit), and it agrees step by step, reset by reset."""

import time

import pytest
import torch

from portbench import draws, harness, reference
from portbench.entries._env import flat
from portbench.reference import env as ref_env, policy

CPU = torch.device("cpu")
CELLS = ["default.rollout_4m", "robust_full_r4d.rollout_4m", "default.env_4m",
         "robust_full_r4d.env_4m"]


@pytest.mark.parametrize("cell", CELLS)
def test_run_agrees(cell):
    r = harness.run(cell, 2**31 + 7, 0.2, False, CPU, time.perf_counter(), n_envs=384)
    assert r["correct"]
    assert r["run"]["numbers"] == {"departed_pct": 0.0, "gap_p99": 0.0, "gap_p999": 0.0,
                                   "gap_max": 0.0, "start_gap": 0.0}
    assert r["run"]["chunks"] >= 1


@pytest.mark.parametrize("config", ["default", "robust_full_r4d"])
def test_reset_and_steps_agree(config):
    """Ten steps of the port's batched step from its own reset against the
    reference's, field by field, with a policy acting."""
    from tvc_ai_torch.env import rocket_env
    from tvc_ai_torch.models.safety import apply_safety
    from tvc_ai_torch.agents import sac

    spec = harness.load_cell(f"{config}.rollout_4m")
    n = 256
    prog = harness.entry(spec["traffic"]["entry"]).Run(spec, 11, CPU, n)
    p, weights = prog.p, prog.weights
    gen = torch.Generator(device=CPU)
    d0 = draws.first_reset(p, n, 11, gen, CPU)
    state, obs = prog.port.reset(d0)
    r_state, r_obs = ref_env.reset(p, d0)
    assert torch.equal(obs, r_obs)

    def act(p, o, d):
        return policy.act(p, weights, o, d["n_act"])

    for d in draws.for_chunk(p, n, 11, 0, 10, prog.act_draws, gen, CPU):
        action = sac.select_action(prog.actor, obs, d["n_act"])
        if prog.safety is not None:
            action, _ = apply_safety(obs, action, prog.safety)
        state, out, obs = rocket_env.batched_step_autoreset(
            state, action, prog.port.env_params, n_imu=d.get("n_imu"), u_drop=d.get("u_drop"),
            reset_draws=rocket_env.ResetDraws(**d["reset"]))
        r_state, r_obs, r_rew, r_term, r_trunc = reference.chunk(p, act, r_state, r_obs, [d])
        torch.testing.assert_close(obs, r_obs, rtol=0, atol=0)
        torch.testing.assert_close(out.reward, r_rew[0], rtol=0, atol=0)
        assert torch.equal(out.terminated, r_term[0]) and torch.equal(out.truncated, r_trunc[0])
    fields = flat(state)
    assert set(fields) == set(r_state)
    for k, v in fields.items():
        torch.testing.assert_close(v, r_state[k], rtol=0, atol=0, msg=k)
