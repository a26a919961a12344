"""bfloat16 compute of the SAC hidden stacks (``SACConfig.compute_dtype``)
against the JAX package (CPU).

The reference's flax ``Dense`` with ``dtype=bfloat16`` casts the input, the
kernel and the bias to bfloat16, takes the product in bfloat16 and adds the
bias in bfloat16; the heads compute in float32. The port's modules do the
same from float32 parameters carried across with ``convert``. XLA:CPU's
bfloat16 ``dot`` and oneDNN's reduce in their own orders, so the bars are
bfloat16 bars: the forward passes at width 32 within 1e-4 absolute and 1e-3
relative (measured on this CPU: ≤ 6e-7), which is far below what float32
compute gives against the reference's bfloat16 (asserted: more than 10× the
bar). One ``sac.update`` is held by its parameter deltas (the step Adam
took: ±lr on its first step, so an element whose tiny gradient rounds to the
other sign moves by 2·lr): all but 1 % of each network's elements within
1e-5 of the reference's delta, every element within 2·lr + 1e-5; its losses
and metrics within 1e-3 relative.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import np_tree, update_draws
from test_torch_sac import ACT, BATCH, OBS, random_batch
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.agents.legacy import SACAgent
from tvc_ai_torch.config import loader as t_loader
from tvc_ai_torch.convert import actor_from_flax, critic_from_flax, sac_state_from_numpy
from tvc_ai_torch.models.mlp import GaussianActor as TActor
from tvc_ai_torch.models.mlp import TwinQ as TTwinQ
from tvc_ai_torch.models.transformer import TransformerActor
from tvc_ai_torch.training.trainer import Trainer
from tvc_ai_torch.training.trainer_ensemble import EnsembleTrainer
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.models.mlp import GaussianActor as JActor
from tvc_ai_tpu.models.mlp import TwinQ as JTwinQ

torch.set_num_threads(1)
HIDDEN = (32, 32)
BF16 = dict(atol=1e-4, rtol=1e-3)
ROWS = 256
LR = 3e-4


def _inputs(seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(ROWS, OBS)).astype(np.float32),
            rng.uniform(-1.0, 1.0, size=(ROWS, ACT)).astype(np.float32))


def _assert_bf16_close(port: torch.Tensor, ref, fp32: torch.Tensor, what: str) -> None:
    """``port`` at the bar; float32 compute misses it by more than ten times."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.detach().numpy(), ref, **BF16, err_msg=what)
    excess = np.abs(fp32.detach().numpy() - ref) - BF16["rtol"] * np.abs(ref)
    assert excess.max() > 10 * BF16["atol"], what


@pytest.mark.parametrize("seed", [0, 1])
def test_actor_forward_matches_jax_bf16(seed):
    actor = JActor(action_dim=ACT, hidden_dims=HIDDEN, dtype=jnp.bfloat16)
    params = actor.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)))
    obs, _ = _inputs(seed)
    j_mean, j_log_std = actor.apply(params, jnp.asarray(obs))
    assert j_mean.dtype == jnp.float32
    ported, fp32 = (TActor(OBS, ACT, HIDDEN, device="cpu", dtype=d)
                    for d in (torch.bfloat16, torch.float32))
    for m in (ported, fp32):
        m.load_state_dict(actor_from_flax(np_tree(params)))
    assert all(p.dtype == torch.float32 for p in ported.parameters())
    with torch.no_grad():
        mean, log_std = ported(torch.from_numpy(obs))
        f_mean, f_log_std = fp32(torch.from_numpy(obs))
    assert mean.dtype == log_std.dtype == torch.float32
    _assert_bf16_close(mean, j_mean, f_mean, "mean")
    _assert_bf16_close(log_std, j_log_std, f_log_std, "log_std")


@pytest.mark.parametrize("seed", [0, 1])
def test_twinq_forward_matches_jax_bf16(seed):
    critic = JTwinQ(hidden_dims=HIDDEN, dtype=jnp.bfloat16)
    params = critic.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)), jnp.zeros((1, ACT)))
    obs, act = _inputs(seed + 10)
    j_q1, j_q2 = critic.apply(params, jnp.asarray(obs), jnp.asarray(act))
    ported, fp32 = (TTwinQ(OBS, ACT, HIDDEN, device="cpu", dtype=d)
                    for d in (torch.bfloat16, torch.float32))
    for m in (ported, fp32):
        m.load_state_dict(critic_from_flax(np_tree(params)))
    with torch.no_grad():
        q1, q2 = ported(torch.from_numpy(obs), torch.from_numpy(act))
        f1, f2 = fp32(torch.from_numpy(obs), torch.from_numpy(act))
    assert q1.dtype == torch.float32 and q1.shape == (ROWS,)
    _assert_bf16_close(q1, j_q1, f1, "q1")
    _assert_bf16_close(q2, j_q2, f2, "q2")


def test_update_deltas_and_losses_match_jax_bf16():
    kwargs = dict(hidden_dims=HIDDEN, batch_size=BATCH, gradient_clip_norm=5.0,
                  reward_scale=0.05, compute_dtype="bfloat16", lr_actor=LR, lr_critic=LR)
    j_cfg, t_cfg = j_sac.SACConfig(**kwargs), t_sac.SACConfig(**kwargs)
    j_state = j_sac.init(jax.random.PRNGKey(4), OBS, ACT, j_cfg)
    port = sac_state_from_numpy(np_tree(j_state), t_cfg, OBS, ACT, device="cpu")
    assert port.critic.q1.dtype == port.actor.dtype == torch.bfloat16
    before = {net: [p.detach().clone() for p in getattr(port, net).parameters()]
              for net in ("actor", "critic")}
    batch = random_batch(np.random.default_rng(6))
    key = jax.random.PRNGKey(100)
    j_state, j_metrics = jax.jit(lambda s, b, k: j_sac.update(s, b, k, j_cfg, OBS, ACT))(
        j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    port, metrics = t_sac.update(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 t_cfg, update_draws(key, BATCH, ACT))
    ref = sac_state_from_numpy(np_tree(j_state), t_cfg, OBS, ACT, device="cpu")
    for net in ("actor", "critic"):
        got = torch.cat([(p.detach() - b).flatten() for p, b in
                         zip(getattr(port, net).parameters(), before[net])])
        want = torch.cat([(q.detach() - b).flatten() for q, b in
                          zip(getattr(ref, net).parameters(), before[net])])
        err = (got - want).abs()
        assert float(want.abs().max()) == pytest.approx(LR, rel=1e-3), net  # Adam's first step
        assert float(err.max()) <= 2 * LR + 1e-5, net
        assert int((err > 1e-5).sum()) <= 0.01 * err.numel(), net
    assert all(p.dtype == torch.float32 for p in port.critic.parameters())
    assert sorted(metrics) == sorted(j_metrics)
    for k, v in metrics.items():
        assert v.dtype == torch.float32, k
        np.testing.assert_allclose(v.numpy(), np.asarray(j_metrics[k]), rtol=1e-3, atol=1e-6,
                                   err_msg=k)


def test_bf16_keeps_params_and_actions_float32():
    """The port's counterpart of ``tests/test_sac.py::test_bfloat16_compute_dtype``."""
    cfg = t_sac.SACConfig(hidden_dims=HIDDEN, batch_size=8, compute_dtype="bfloat16")
    agent = t_sac.init(OBS, ACT, cfg, device="cpu")
    assert all(p.dtype == torch.float32 for net in (agent.actor, agent.critic,
                                                    agent.target_critic)
               for p in net.parameters())
    gen = torch.Generator().manual_seed(2)
    obs = torch.randn(8, OBS, generator=gen)
    a = t_sac.select_action(agent.actor, obs, generator=gen)
    assert a.dtype == torch.float32 and bool((a.abs() <= 1.0).all())
    batch = {k: torch.from_numpy(v[:8]) for k, v in random_batch(np.random.default_rng(3)).items()}
    agent, m = t_sac.update(agent, batch, cfg, generator=gen)
    assert all(torch.isfinite(v) and v.dtype == torch.float32 for v in m.values())
    assert all(p.dtype == torch.float32 for p in agent.actor_opt.mu + agent.critic_opt.nu)


def test_compute_dtype_names_and_transformer():
    with pytest.raises(ValueError, match="compute_dtype"):
        t_sac.SACConfig(compute_dtype="float16")
    with pytest.raises(ValueError, match="compute dtype"):
        TActor(OBS, ACT, HIDDEN, device="cpu", dtype=torch.float16)
    # the reference gives the transformer actor no dtype: only the critic computes in bf16
    cfg = t_sac.SACConfig(architecture="transformer", transformer_d_model=16,
                          transformer_layers=1, transformer_heads=2, hidden_dims=(16, 16),
                          compute_dtype="bfloat16")
    agent = t_sac.init(OBS, ACT, cfg, device="cpu")
    assert isinstance(agent.actor, TransformerActor)
    assert agent.critic.q1.dtype == agent.critic.q2.dtype == torch.bfloat16
    assert agent.target_critic.q1.dtype == torch.bfloat16
    assert dataclasses.replace(cfg, compute_dtype="float32").compute_dtype == "float32"


SMALL = ["training.num_envs=8", "training.rollout_steps=16", "training.eval_freq=128",
         "training.eval_episodes=2", "algorithms.sac.hidden_dims=[16,16]",
         "algorithms.td3.hidden_dims=[16,16]", "algorithms.td3.batch_size=16",
         "algorithms.sac.buffer_size=2048", "algorithms.sac.learning_starts=64",
         "algorithms.sac.batch_size=16", "algorithms.ppo.n_epochs=2", "curriculum.enabled=false",
         "logging.tensorboard=false", "algorithms.sac.compute_dtype=bfloat16"]


@pytest.mark.parametrize("algo", ["sac", "ensemble"])
def test_trainers_run_in_bf16(tmp_path, algo):
    """The YAML route: the solo trainer and the ensemble's SAC member build
    their networks in bfloat16 and learn."""
    cfg = t_loader.load_config(None, [f"globals.output_dir={tmp_path}",
                                      f"training.algorithm={algo}",
                                      "training.total_timesteps=256", *SMALL])
    cls = Trainer if algo == "sac" else EnsembleTrainer
    trainer = cls(cfg, output_dir=tmp_path / "run", device="cpu")
    agent = trainer.carry.agent if algo == "sac" else trainer.carry.sac
    assert agent.actor.dtype == agent.critic.q1.dtype == torch.bfloat16
    result = trainer.train()
    assert result["env_steps"] >= 256 and agent.step > 0
    assert all(torch.isfinite(p).all() for p in agent.critic.parameters())


def test_legacy_agent_runs_in_bf16():
    agent = SACAgent(OBS, ACT, t_sac.SACConfig(hidden_dims=(16, 16), batch_size=8,
                                                learning_starts=8, compute_dtype="bfloat16"),
                     device="cpu")
    assert agent.state.critic.q1.dtype == torch.bfloat16
    rng = np.random.default_rng(1)
    for _ in range(12):
        obs = rng.normal(size=OBS).astype(np.float32)
        action = agent.select_action(obs)
        assert action.dtype == np.float32 and np.all(np.abs(action) <= 1.0)
        agent.store_transition(obs, action, 1.0, obs, False)
    metrics = agent.train()
    assert metrics and all(np.isfinite(v) for v in metrics.values())
