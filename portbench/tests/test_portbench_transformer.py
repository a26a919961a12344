"""The transformer cell (``transformer_r3.history_rollout_4m``) on the CPU at
small N: a run of the program reads correct; the control and two faults
planted in copies of the act path (the window not refilled where an episode
ended; LayerNorm's epsilon 1e-5 in place of flax's 1e-6) read not correct;
a traced run's new metrics find their spans; the actor's yardstick and
weights fit the actor that ``sac.make_actor`` builds."""

import dataclasses
import time

import pytest
import torch

from portbench import harness, tracing, transformer_yardsticks, yardsticks

CPU = torch.device("cpu")
CELL = "transformer_r3.history_rollout_4m"
NEW_METRICS = ("transformer_encoder_ms_per_step", "transformer_head_ms_per_step",
               "transformer_roofline", "history_ms_per_step")


def run(seed=2**33 + 5, system="program", trace=False, n_envs=256):
    return harness.run(CELL, seed, 0.2, trace, CPU, time.perf_counter(), n_envs=n_envs,
                       system=system)


@pytest.mark.parametrize("seed", [3, 2**31 + 1, 2**40 + 9])
def test_program_correct(seed):
    r = run(seed)
    assert r["correct"], r["checks"]
    assert r["run"]["numbers"]["departed_pct"] == 0.0


@pytest.mark.parametrize("seed", [3, 2**40 + 9])
def test_control_fails(seed):
    r = run(seed, system="control")
    assert not r["correct"]
    assert r["checks"]["actor_gap"]["value"] > r["checks"]["actor_gap"]["limit"]


def _no_refill(window, out_obs, next_obs, done):
    """A copy of the window's update that shifts the true next observation
    in everywhere, the fresh episode's first observation nowhere."""
    if window is None:
        return window, out_obs, next_obs
    shifted = torch.cat([window[:, 1:], out_obs[:, None, :]], dim=1)
    flat = shifted.reshape(shifted.shape[0], -1)
    return shifted, flat, flat


def _layer_norm_eps_1e5(self, x):
    """A copy of the port's LayerNorm with torch's default epsilon."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return (x - mean) * (torch.rsqrt(var + 1e-5) * self.weight) + self.bias


@pytest.mark.parametrize("fault", ["no_refill", "layer_norm_eps_1e5"])
def test_fault_fails(fault, monkeypatch):
    from tvc_ai_torch.models import layers
    from tvc_ai_torch.training import loop
    if fault == "no_refill":
        monkeypatch.setattr(loop, "next_window", _no_refill)
    else:
        monkeypatch.setattr(layers.LayerNorm, "forward", _layer_norm_eps_1e5)
    r = run()
    assert not r["correct"], r["checks"]


def _cpu_ops(prof) -> list[tuple[str, float, tuple]]:
    """Each leaf aten operation of a CPU trace, with its host time and the
    benchmark's spans around it, outermost first: the CPU's stand-in for the
    device operations a card's trace holds."""
    ops = []
    for e in prof.events():
        if not e.name.startswith("aten::") or any(
                c.name.startswith("aten::") for c in e.cpu_children):
            continue
        spans, up = [], e.cpu_parent
        while up is not None:
            if up.name.startswith(tracing.PREFIX):
                spans.append(up.name)
            up = up.cpu_parent
        ops.append((e.name, e.cpu_time_total / 1e6, tuple(reversed(spans))))
    return ops


def test_new_metrics_read_a_cpu_trace(monkeypatch):
    real = tracing.read

    def read(prof, steps):
        return dataclasses.replace(real(prof, steps), ops=_cpu_ops(prof))

    monkeypatch.setattr(tracing, "read", read)
    r = run(trace=True, n_envs=128)
    values = {k: m["value"] for k, m in r["metrics"].items()}
    for name in NEW_METRICS + ("act_ms_per_step", "env_ms_per_step"):
        assert values.get(name, 0) > 0, (name, values)
    # the encoder and the head tile the actor inside the act layer
    assert (values["transformer_encoder_ms_per_step"] + values["transformer_head_ms_per_step"]
            < values["act_ms_per_step"])


def test_yardstick_and_weights_fit_the_actor():
    spec = harness.load_cell(CELL)
    r = harness.entry(spec["traffic"]["entry"]).Run(spec, 0, CPU, 4)
    s = transformer_yardsticks.shape(spec["config"])
    net = r.actor.TransformerPolicyNetwork_0
    counted = sum(2 * m.in_features * m.out_features for name, m in net.named_modules()
                  if isinstance(m, torch.nn.Linear) and not name.startswith("_Head_1")
                  and not name.endswith(("query", "key")))
    assert counted == transformer_yardsticks.actor_flops_per_row(s) == 1_329_152
    assert r.flops_per_env_step == counted + yardsticks.k1_flops_per_env(r.p.rocket.substeps)
    drawn = set(r.tf_weights)
    assert drawn == {n for n, _ in net.named_parameters() if not n.startswith("_Head_1")}
    assert net.EncoderLayer_0.Dense_0.out_features == s.feed_forward_dim == 512
    assert net._Head_0.Dense_1.out_features == s.head_hidden_dims[1] == 512
    assert net.Dense_0.in_features == s.token_dim == r.p.obs_dim * s.history_len


@pytest.mark.card
def test_card_run_correct(card):
    """A short run of the cell on the card at 2^16 envs checks correct."""
    r = harness.run(CELL, 2**31 + 3, 1.0, False, card, time.perf_counter(), n_envs=1 << 16)
    assert r["correct"], r["checks"]
