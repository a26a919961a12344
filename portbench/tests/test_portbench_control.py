"""The check fails what it must: the control (the reference one precision
lower in the program's place) and each fault the cells can have, planted in
the timed path underneath an otherwise whole run on the CPU."""

import dataclasses
import time

import pytest
import torch

from portbench import harness

CPU = torch.device("cpu")
CELLS = ["default.rollout_4m", "robust_full_r4d.rollout_4m", "default.env_4m",
         "robust_full_r4d.env_4m"]


def run(cell, seed=2**33 + 5, system="program"):
    return harness.run(cell, seed, 0.2, False, CPU, time.perf_counter(), n_envs=384,
                       system=system)


@pytest.mark.parametrize("seed", [3, 2**31 + 1, 2**40 + 9])
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell, seed):
    r = run(cell, seed, system="control")
    assert not r["correct"]
    assert r["checks"]["gap_p99"]["value"] > r["checks"]["gap_p99"]["limit"]


def _unchanged(real):
    """A step that returns its state unchanged (the output is the real one)."""
    def step(states, actions, params, **kw):
        _, out, obs = real(states, actions, params, **kw)
        return states, out, obs
    return step


def _half(real):
    """A step that leaves the second half of the batch out: those envs keep
    their state and observation."""
    def step(states, actions, params, **kw):
        new, out, obs = real(states, actions, params, **kw)
        n = actions.shape[0]
        keep = torch.arange(n) >= n // 2

        def pick(a, b):
            return torch.where(keep.view(-1, *([1] * (a.dim() - 1))), a, b)

        from tvc_ai_torch.utils.tree import tree_map
        return tree_map(pick, states, new), out, pick(out.obs, obs)
    return step


def _altered(real):
    """A step whose answer is altered where it is produced: ten reward units
    added to every env's reward (rewards run from -1000 to 200, most near
    50-100)."""
    def step(states, actions, params, **kw):
        new, out, obs = real(states, actions, params, **kw)
        return new, dataclasses.replace(out, reward=out.reward + 10.0), obs
    return step


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_fails(cell, fault, monkeypatch):
    from tvc_ai_torch.env import rocket_env
    monkeypatch.setattr(rocket_env, "batched_step_autoreset",
                        fault(rocket_env.batched_step_autoreset))
    assert not run(cell)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_card_run_correct(cell, card):
    """A short run of each cell on the card at 2^16 envs checks correct."""
    r = harness.run(cell, 2**31 + 3, 1.0, False, card, time.perf_counter(), n_envs=1 << 16)
    assert r["correct"], r["checks"]
