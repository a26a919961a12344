"""The port's spans and counters (``tvc_ai_torch.utils.profiling``) on the
CPU, at the benchmark's two configurations: off, they record nothing and
change nothing; on, the sub-layer spans tile their layer and the autoreset's
counter counts the rows it kept and built."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tvc_ai_torch.agents import sac
from tvc_ai_torch.config import build, loader
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.training import loop
from tvc_ai_torch.utils import profiling
from tvc_ai_torch.utils.checkpoint import diff_states

CONFIGS = ["default.yaml", "robust_full_r4d.yaml"]
N, STEPS = 64, 6
ENV_CHILDREN = (profiling.ENV_PRE, profiling.ENV_INTEGRATE, profiling.ENV_STATUS,
                profiling.ENV_OBSERVE, profiling.ENV_REWARD, profiling.ENV_AUTORESET)
ACT_CHILDREN = (profiling.ACT_ACTOR, profiling.ACT_SAMPLE, profiling.ACT_SAFETY)


@dataclasses.dataclass
class Setup:
    params: object
    safety: object
    actor: torch.nn.Module


@pytest.fixture(scope="module", params=CONFIGS)
def setup(request):
    path = Path(rocket_env.__file__).resolve().parent.parent / "config" / request.param
    fc = loader.load_config(path)
    # episodes truncated after 3 steps, so the autoreset keeps rows within a few steps
    params = dataclasses.replace(build.build_env_params(fc), max_episode_steps=3)
    cfg = build.build_loop_config(fc)
    actor = sac.make_actor(cfg.obs_dim, 2, build.build_sac_config(fc), "cpu")
    return Setup(params, cfg.safety if cfg.use_safety_layer else None, actor)


def _start(s: Setup, seed: int = 0):
    return rocket_env.reset(s.params, N, "cpu", torch.Generator().manual_seed(seed))


def _env_steps(s: Setup, seed: int = 1):
    """STEPS autoreset steps from a fresh reset, uniform actions; every output."""
    state, _ = _start(s)
    gen = torch.Generator().manual_seed(seed)
    outs = []
    for _ in range(STEPS):
        action = torch.rand((N, 2), generator=gen) * 2 - 1
        state, out, obs = rocket_env.batched_step_autoreset(state, action, s.params,
                                                            generator=gen)
        outs.append((out, obs))
    return state, outs


def _collect(s: Setup, seed: int = 1):
    state, obs = _start(s)
    return loop.collect(s.actor, state, obs, s.params, STEPS, safety=s.safety,
                        generator=torch.Generator().manual_seed(seed))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_span_off_is_the_shared_noop(setup):
    assert not profiling.tracing()
    assert profiling.span(profiling.ENV) is profiling.span(profiling.ACT_ACTOR)
    profiling.counters()
    _env_steps(setup)
    _collect(setup)
    assert profiling.counters() == {}


@pytest.mark.parametrize("run", [_env_steps, _collect], ids=["env_step", "collect"])
def test_traced_outputs_equal_untraced(setup, run):
    plain = run(setup)
    with _cpu_profile():
        traced = run(setup)
    profiling.counters()
    assert diff_states(plain, traced) == []


def _leaf_ops_under(events, parent: str) -> list[list[str]]:
    """For each leaf aten op with ``parent`` among its enclosing spans, the
    names of those spans."""
    stacks = []
    for e in events:
        if not e.name.startswith("aten::") or any(
                c.name.startswith("aten::") for c in e.cpu_children):
            continue
        names, up = [], e.cpu_parent
        while up is not None:
            names.append(up.name)
            up = up.cpu_parent
        if parent in names:
            stacks.append(names)
    return stacks


@pytest.mark.parametrize("run,parent,children", [
    (_env_steps, profiling.ENV, ENV_CHILDREN),
    (_collect, profiling.ENV, ENV_CHILDREN),
    (_collect, profiling.ACT, ACT_CHILDREN),
], ids=["env_step", "collect_env", "collect_act"])
def test_children_tile_their_layer(setup, run, parent, children):
    """Every leaf op inside the layer's span is inside exactly one child."""
    with _cpu_profile() as prof:
        run(setup)
    profiling.counters()
    stacks = _leaf_ops_under(prof.events(), parent)
    assert stacks
    for names in stacks:
        assert sum(n in children for n in names) == 1, names
    seen = {n for names in stacks for n in names if n in children}
    want = set(children) - ({profiling.ACT_SAFETY} if setup.safety is None else set())
    assert seen == want


def test_spans_stay_off_the_device_timeline(setup):
    """The spans are host operator events, not user annotations: a profiler
    mirrors each user annotation onto the device timeline, where a trace
    reader would count it as device work."""
    with _cpu_profile() as prof:
        _collect(setup)
    profiling.counters()
    spans = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("tvc.")]
    assert {e.name() for e in spans} >= {profiling.ACT, profiling.ENV, *ENV_CHILDREN}
    assert not any(e.is_user_annotation() for e in spans)


def test_autoreset_counters(setup):
    """kept sums each step's ``done``; built is N a step; reading clears."""
    profiling.counters()
    with _cpu_profile():
        _, outs = _env_steps(setup)
    kept = sum(int((out.terminated | out.truncated).sum()) for out, _ in outs)
    got = profiling.counters()
    assert got == {profiling.AUTORESET_KEPT: float(kept),
                   profiling.AUTORESET_BUILT: float(N * STEPS)}
    assert 0 < kept < N * STEPS
    assert profiling.counters() == {}
