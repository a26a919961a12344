"""The frozen yardsticks, derived again from today's shapes: K1's I/O and
operation count from the port's kernel wrapper, the actor's FLOPs from its
layers, the env step's least bytes from a real step's state, draws and
output."""

import pytest
import torch

from portbench import draws, harness, yardsticks
from portbench.entries._env import flat

CPU = torch.device("cpu")


def test_k1_counts():
    from tvc_ai_torch.ops import step_kernel as k1
    size = {torch.float32: 4, torch.bool: 1}
    read = sum(size[dt] * (tail[0] if tail else 1) for _, tail, dt in k1.INPUTS)
    assert read + 4 * sum(k1.OUTPUT_WIDTHS) == yardsticks.k1_bytes_per_env() == 145
    for substeps in (1, 4, 8):
        assert k1.flops_per_env(substeps) == yardsticks.k1_flops_per_env(substeps)
    assert yardsticks.k1_flops_per_env(4) == 1335


@pytest.mark.parametrize("config, flops", [("default", 138_240), ("robust_full_r4d", 140_288)])
def test_actor_flops(config, flops):
    spec = harness.load_cell(f"{config}.rollout_4m")
    run = harness.entry(spec["traffic"]["entry"]).Run(spec, 0, CPU, 4)
    counted = sum(2 * m.in_features * m.out_features for m in run.actor.modules()
                  if isinstance(m, torch.nn.Linear))
    assert counted == yardsticks.actor_flops_per_row(run.p) == flops
    assert run.flops_per_env_step == flops + yardsticks.k1_flops_per_env(run.p.rocket.substeps)


def _bytes(tensors) -> int:
    return sum(t[0].numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("config, least", [("default", 636), ("robust_full_r4d", 940)])
def test_env_step_bytes(config, least):
    spec = harness.load_cell(f"{config}.env_4m")
    run = harness.entry(spec["traffic"]["entry"]).Run(spec, 1, CPU, 8)
    p = run.p
    run.start()
    d = next(draws.for_chunk(p, 8, 1, 0, 1, run.act_draws, torch.Generator(), CPU))
    new, out, next_obs = run.port.step(run.state, d["u_act"], d)
    assert run.flops_per_env_step == yardsticks.k1_flops_per_env(p.rocket.substeps)
    state_b = _bytes(flat(new).values())
    assert state_b == yardsticks.env_state_bytes(p)
    step_draws = [v for k, v in d.items() if k not in ("reset", "u_act")]
    assert _bytes(step_draws + list(d["reset"].values())) == yardsticks.draws_bytes(p)
    outs = [v for v in vars(out).values() if isinstance(v, torch.Tensor)]
    outs += list(out.reward_components.values()) + [next_obs]
    assert _bytes(outs) == yardsticks.step_output_bytes(p)
    assert yardsticks.env_step_bytes_per_env(p) == least
