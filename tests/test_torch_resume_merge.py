"""A resume that turns optional state on or off, against the JAX trainer (CPU).

The reference's ``Trainer._resume`` merges the checkpoint into the fresh
carry field by field (its ``fill``): where the checkpoint holds None the
fresh carry's value stays, and where the fresh carry holds None the disk's
value goes unused. The port merges both kinds of checkpoint the same way
(``utils.checkpoint.merge_state``): its own ``torch.save`` checkpoints and
the JAX package's orbax ones.

Two directions, from one narrow JAX ``Trainer`` run (64 envs, 32×32, EMA and
RND on, one 2-step iteration) shared by the module, saved twice:

- "on": its checkpoint without the EMA actor and the RND state (as a run
  with both off writes it), resumed with ``algorithms.sac.ema_decay=0.999``
  and RND on;
- "off": its checkpoint with both, resumed with both off.

Each is resumed by the JAX ``Trainer`` and by the port on both routes: the
orbax checkpoint itself, and the port's own checkpoint of it (a port
trainer at the writer's config resumes the orbax one and saves). The port's
fresh EMA actor and RND state are the JAX fresh carry's, carried across by
``convert``, since seeded initial weights differ between the packages. The
bars: the resumed carry equal to ``convert`` of the JAX resumed carry, bit
for bit (the EMA and RND parameters also at 1e-6), with no raw dict in it;
one iteration afterwards on the JAX iteration's draws at the loop's bars
(obs 5e-5 / 5e-4, rewards 1e-3, counts exact, parameters 1e-4, metrics 1e-3
relative); then ``train()`` for one more iteration and its eval round.
"""

from __future__ import annotations

import copy
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from test_torch_orbax import NARROW
from test_torch_parity_utils import KeyChain, iteration_draws, np_tree, recording_batched_keys
from tvc_ai_torch.agents import replay as t_replay
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.config import load_config as t_load_config
from tvc_ai_torch.convert import (
    actor_from_flax,
    env_params_from_numpy,
    rnd_state_from_numpy,
    sac_state_from_numpy,
    train_carry_from_numpy,
)
from tvc_ai_torch.training import loop as t_loop
from tvc_ai_torch.training.trainer import Trainer
from tvc_ai_torch.utils.checkpoint import (
    diff_states,
    flat_state,
    load_state,
    merge_state,
    state_of,
)
from tvc_ai_tpu.config import load_config as j_load_config
from tvc_ai_tpu.training import loop as j_loop
from tvc_ai_tpu.training.trainer import Trainer as JTrainer
from tvc_ai_tpu.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)
STEPS = 2
OBS = dict(atol=5e-5, rtol=5e-4)
REWARD = dict(atol=1e-3, rtol=1e-3)
PARAMS = dict(atol=1e-4, rtol=0.0)
BAR = dict(atol=1e-6, rtol=0.0)
OPTIONS = ["algorithms.sac.ema_decay=0.999",
           "exploration.random_network_distillation.enabled=true",
           "exploration.random_network_distillation.network_size=[32,16]"]
OFF = ["algorithms.sac.ema_decay=0.0",
       "exploration.random_network_distillation.enabled=false",
       "exploration.random_network_distillation.network_size=[32,16]"]
# direction: (the checkpoint's options, the resumed config's)
DIRECTIONS = {"on": (OFF, OPTIONS), "off": (OPTIONS, OFF)}
ROUTES = ("orbax", "own")


def port_trainer(out, overrides, fresh_j=None) -> Trainer:
    """A fresh port ``Trainer``; with ``fresh_j`` (a JAX fresh carry as
    numpy), its EMA actor and RND state are that carry's."""
    tr = Trainer(t_load_config(None, [f"globals.output_dir={out}", *NARROW, *overrides]),
                 output_dir=out, device="cpu")
    if fresh_j is not None:
        if tr.carry.agent.ema_actor is not None:
            tr.carry.agent.ema_actor.load_state_dict(
                actor_from_flax(fresh_j.agent.ema_actor_params))
        if tr.carry.rnd is not None:
            tr.carry.rnd = rnd_state_from_numpy(fresh_j.rnd, tr.loop_cfg.rnd, "cpu")
    return tr


def snapshot(carry) -> dict:
    return copy.deepcopy(flat_state(carry))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{direction: the orbax root it resumes}: one JAX run with both options
    on after one iteration, saved with them ("off") and without ("on")."""
    out = tmp_path_factory.mktemp("merge_writer")
    tr = JTrainer(j_load_config(None, [f"globals.output_dir={out}", *NARROW, *OPTIONS]),
                  output_dir=out)
    tr.carry, _ = tr._train_fn(tr.carry, tr.env_params)
    tr.iteration += 1
    bare = tr.carry.replace(rnd=None, agent=tr.carry.agent.replace(ema_actor_params=None))
    roots = {"off": out / "with", "on": out / "without"}
    for direction, carry in (("off", tr.carry), ("on", bare)):
        mngr = CheckpointManager(roots[direction])
        mngr.save(tr.env_steps, carry, tr._host_state())
        mngr.wait()
    return roots


@pytest.fixture(scope="module", params=sorted(DIRECTIONS))
def run(request, checkpoints, tmp_path_factory):
    written, resumed = DIRECTIONS[request.param]
    out = tmp_path_factory.mktemp(f"merge_{request.param}")
    root = checkpoints[request.param]

    # the JAX trainer's resume, then one recorded iteration
    jt = JTrainer(j_load_config(None, [f"globals.output_dir={out}/jax", *NARROW, *resumed]),
                  output_dir=out / "jax")
    fresh_j = np_tree(jt.carry)
    jt._resume(root)
    j_resumed = jt.carry
    with recording_batched_keys() as keys:
        j_it = jax.jit(j_loop.make_train_iteration(jt.sac_cfg, jt.loop_cfg))
        j_next, j_metrics = j_it(j_resumed, jt.env_params)
    assert len(keys) == STEPS

    # the port: the orbax checkpoint, and its own checkpoint of the same state
    writer = port_trainer(out / "port_writer", written)
    writer._resume(root)
    writer._save(writer.ckpt, writer.env_steps)
    trainers = {"orbax": port_trainer(out / "port_orbax", resumed, fresh_j),
                "own": port_trainer(out / "port_own", resumed, fresh_j)}
    trainers["orbax"]._resume(root)
    trainers["own"]._resume(writer.ckpt.directory)
    after_resume = {route: snapshot(tr.carry) for route, tr in trainers.items()}

    tr0 = trainers["orbax"]
    size0, cap = tr0.carry.buffer.size, tr0.carry.buffer.capacity
    n = tr0.loop_cfg.num_envs
    sizes = [min(size0 + (t + 1) * n, cap) for t in range(STEPS)]
    draws = iteration_draws(KeyChain(jt.env_params), j_resumed.key, keys, sizes, tr0.sac_cfg,
                            tr0.loop_cfg)
    t_it = t_loop.make_train_iteration(tr0.sac_cfg, tr0.loop_cfg)
    params = env_params_from_numpy(np_tree(jt.env_params))
    iterated = {route: t_it(tr.carry, params, draws) for route, tr in trainers.items()}
    return types.SimpleNamespace(
        direction=request.param, jt=jt, j_resumed=np_tree(j_resumed), j_next=j_next,
        j_metrics=j_metrics, trainers=trainers, after_resume=after_resume, iterated=iterated,
        own_ckpt=writer.ckpt.directory)


def want_resumed(run, route):
    """``convert`` of the JAX resumed carry, with the values the reference
    keeps unused (those the config turns off) left out."""
    tr = run.trainers[route]
    j = run.j_resumed
    if run.direction == "off":
        j = j.replace(rnd=None, agent=j.agent.replace(ema_actor_params=None))
    return train_carry_from_numpy(j, tr.sac_cfg, tr.loop_cfg, device="cpu",
                                  seed=tr.cfg.globals.seed)


def raw_dicts(obj, path="carry") -> list[str]:
    """The paths of the dicts in a carry, other than a replay's rows."""
    if isinstance(obj, t_replay.ReplayBuffer):
        return []
    if isinstance(obj, dict):
        return [path]
    if dataclasses.is_dataclass(obj):
        return [p for f in dataclasses.fields(obj)
                for p in raw_dicts(getattr(obj, f.name), f"{path}.{f.name}")]
    return []


@pytest.mark.parametrize("route", ROUTES)
def test_resume_merges_as_the_jax_trainer(run, route):
    got = run.after_resume[route]
    assert diff_states(got, want_resumed(run, route)) == []
    carry = run.trainers[route].carry
    assert raw_dicts(carry) == []
    on = run.direction == "on"
    assert (carry.agent.ema_actor is not None) == on and (carry.rnd is not None) == on
    if on:   # the fresh side: the JAX fresh carry's, as the reference's fill keeps it
        j = run.j_resumed
        ema = actor_from_flax(j.agent.ema_actor_params)
        for name, value in ema.items():
            np.testing.assert_allclose(got[f"agent.ema_actor.__module_state__.{name}"].numpy(),
                                       value.numpy(), **BAR, err_msg=name)
        rnd = rnd_state_from_numpy(j.rnd, run.trainers[route].loop_cfg.rnd, "cpu")
        for name, value in rnd.predictor.state_dict().items():
            np.testing.assert_allclose(got[f"rnd.predictor.__module_state__.{name}"].numpy(),
                                       value.numpy(), **BAR, err_msg=name)
        for name, value in rnd.target.state_dict().items():
            np.testing.assert_allclose(got[f"rnd.target.__module_state__.{name}"].numpy(),
                                       value.numpy(), **BAR, err_msg=name)


def _assert_modules_close(got: torch.nn.Module, want: torch.nn.Module, what: str) -> None:
    for (name, p), q in zip(got.named_parameters(), want.parameters(), strict=True):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), **PARAMS,
                                   err_msg=f"{what}.{name}")


@pytest.mark.parametrize("route", ROUTES)
def test_one_iteration_after_resume_matches_jax(run, route):
    t, t_metrics = run.iterated[route]
    j = np_tree(run.j_next)
    np.testing.assert_allclose(t.obs.numpy(), j.obs, **OBS)
    assert (t.buffer.ptr, t.buffer.size) == (int(j.buffer.ptr), int(j.buffer.size))
    for k in ("obs", "next_obs", "action"):
        np.testing.assert_allclose(t.buffer.data[k].numpy(), j.buffer.data[k], **OBS, err_msg=k)
    np.testing.assert_allclose(t.buffer.data["reward"].numpy(), j.buffer.data["reward"], **REWARD)
    for name in ("env_steps", "episodes", "successes", "ep_length", "ep_ring_seq", "ep_ring_ptr"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), getattr(j, name), err_msg=name)
    tr = run.trainers[route]
    on = run.direction == "on"
    ref = sac_state_from_numpy(j.agent if on else j.agent.replace(ema_actor_params=None),
                               tr.sac_cfg, t_loop.policy_obs_dim(tr.loop_cfg), 2, device="cpu")
    assert t.agent.step == ref.step > 0
    for net in ("actor", "critic", "target_critic") + (("ema_actor",) if on else ()):
        _assert_modules_close(getattr(t.agent, net), getattr(ref, net), net)
    if on:
        ref_rnd = rnd_state_from_numpy(j.rnd, tr.loop_cfg.rnd, "cpu")
        _assert_modules_close(t.rnd.predictor, ref_rnd.predictor, "rnd.predictor")
        assert t.rnd.step == ref_rnd.step
    assert sorted(t_metrics) == sorted(run.j_metrics)
    for k, v in t_metrics.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(run.j_metrics[k]), rtol=1e-3, atol=1e-5,
                                   err_msg=k)
    assert raw_dicts(t) == []


@pytest.mark.parametrize("route", ROUTES)
def test_train_runs_after_resume(run, route):
    tr = run.trainers[route]
    tr.carry = run.iterated[route][0]
    tr.cfg.training.total_timesteps = tr.env_steps + tr.loop_cfg.num_envs * STEPS
    result = tr.train()
    assert result["iterations"] == run.jt.iteration + 1 and np.isfinite(result["eval_success_rate"])
    assert raw_dicts(tr.carry) == []


# ---------------------------------------------------------------- the rule itself
@dataclasses.dataclass
class Box:
    a: torch.Tensor
    b: torch.nn.Module | None = None
    c: dict | None = None


def test_merge_state_rule():
    fresh = Box(a=torch.zeros(3), b=torch.nn.Linear(2, 2), c={"x": torch.zeros(1)})
    kept_b = fresh.b
    saved = state_of(Box(a=torch.ones(4), b=None, c={"x": torch.ones(1), "y": torch.ones(2)}))
    merged = merge_state(fresh, saved)
    assert torch.equal(merged.a, torch.ones(4))           # the checkpoint's shape wins
    assert merged.b is kept_b                              # None on disk: the fresh module
    assert set(merged.c) == {"x"} and torch.equal(merged.c["x"], torch.ones(1))
    off = merge_state(Box(a=torch.zeros(3)), state_of(Box(a=torch.ones(3),
                                                           b=torch.nn.Linear(2, 2))))
    assert off.b is None and off.c is None                 # off in the config: dropped
    # load_state keeps its rule for the other callers
    plain = load_state(Box(a=torch.zeros(3), b=torch.nn.Linear(2, 2)), saved)
    assert plain.b is None and plain.c == {"x": saved["c"]["x"], "y": saved["c"]["y"]}


def test_shape_changes_stay_refused(run, tmp_path):
    tr = port_trainer(tmp_path, [*DIRECTIONS[run.direction][1],
                                 "algorithms.sac.hidden_dims=[16,16]"])
    with pytest.raises(RuntimeError, match="size mismatch"):
        tr._resume(run.own_ckpt)


def test_convert_keeps_its_ema_rule(run):
    """``sac_state_from_numpy`` still refuses an EMA actor present on one
    side only; ``ema_from_state`` follows the state."""
    agent = run.j_resumed.agent
    if run.direction == "off":
        agent = agent.replace(ema_actor_params=None)
    cfg = t_sac.SACConfig(hidden_dims=(32, 32), ema_decay=0.0 if run.direction == "on" else 0.999)
    with pytest.raises(ValueError, match="EMA actor"):
        sac_state_from_numpy(agent, cfg, 10, 2, device="cpu")
    state = sac_state_from_numpy(agent, cfg, 10, 2, device="cpu", ema_from_state=True)
    assert (state.ema_actor is not None) == (agent.ema_actor_params is not None)
