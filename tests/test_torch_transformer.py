"""The transformer policy of tvc_ai_torch against the JAX package (CPU).

``TransformerPolicyNetwork`` at sequence length 1 and 4 (mean, log_std and
value), ``TransformerActor``, ten ``sac.update``s with the transformer actor
and an EMA actor, and ``convert`` of a JAX transformer SAC state, all at
d_model 32, 2 heads, 2 layers, the weights carried across by ``convert``.
Bars: the forward 2e-5; after ten updates every parameter and Adam moment
1e-4, the metrics 1e-4 relative.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import np_tree, update_draws
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import _dense_layers, actor_from_flax, sac_state_from_numpy
from tvc_ai_torch.models import transformer as t_tf
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.models import transformer as j_tf

torch.set_num_threads(1)
FRAME, HISTORY, ACT, BATCH = 10, 4, 2, 16
OBS = FRAME * HISTORY
D_MODEL, HEADS, LAYERS = 32, 2, 2
FORWARD = dict(atol=2e-5, rtol=2e-5)
UPDATES = 10
SAC = dict(hidden_dims=(32, 32), batch_size=BATCH, gradient_clip_norm=5.0, reward_scale=0.05,
           architecture="transformer", transformer_d_model=D_MODEL, transformer_heads=HEADS,
           transformer_layers=LAYERS, ema_decay=0.9, automatic_entropy_tuning=False, alpha=0.05)


def test_sinusoidal_encoding_matches_jax():
    np.testing.assert_array_equal(t_tf.sinusoidal_encoding(50, D_MODEL).numpy(),
                                  np.asarray(j_tf.sinusoidal_encoding(50, D_MODEL)))


@pytest.mark.parametrize("seq", [1, HISTORY], ids=["seq1", "seq4"])
def test_policy_network_matches_jax(seq):
    net = j_tf.TransformerPolicyNetwork(action_dim=ACT, d_model=D_MODEL, num_heads=HEADS,
                                        num_layers=LAYERS)
    rng = np.random.default_rng(seq)
    obs = rng.normal(size=(24, OBS)).astype(np.float32) * 2.0
    params = net.init(jax.random.PRNGKey(seq), jnp.asarray(obs), sequence_length=seq)
    port = t_tf.TransformerPolicyNetwork(OBS // seq, ACT, D_MODEL, HEADS, LAYERS, device="cpu")
    port.load_state_dict(_dense_layers(np_tree(params)))
    j_mean, j_log_std, j_value = net.apply(params, jnp.asarray(obs), sequence_length=seq)
    with torch.no_grad():
        mean, log_std, value = port(torch.from_numpy(obs), sequence_length=seq)
    for got, want, what in ((mean, j_mean, "mean"), (log_std, j_log_std, "log_std"),
                            (value, j_value, "value")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORWARD, err_msg=what)
    # the window as (B, S, frame) gives the same
    with torch.no_grad():
        again = port(torch.from_numpy(obs).reshape(24, seq, -1))
    np.testing.assert_array_equal(again[0].numpy(), mean.numpy())


def test_actor_matches_jax():
    actor = j_tf.TransformerActor(action_dim=ACT, d_model=D_MODEL, num_heads=HEADS,
                                  num_layers=LAYERS)
    params = actor.init(jax.random.PRNGKey(3), jnp.zeros((1, OBS)))
    port = t_tf.TransformerActor(OBS, ACT, D_MODEL, HEADS, LAYERS, device="cpu")
    port.load_state_dict(actor_from_flax(np_tree(params)))
    assert not hasattr(port, "hidden_0")   # the dormant-unit surgery leaves it alone
    obs = np.random.default_rng(4).normal(size=(32, OBS)).astype(np.float32)
    j_mean, j_log_std = actor.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        mean, log_std = port(torch.from_numpy(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), **FORWARD)
    np.testing.assert_allclose(log_std.numpy(), np.asarray(j_log_std), **FORWARD)
    # the flax tree's layout: the default feed-forward and head widths
    net = port.TransformerPolicyNetwork_0
    assert net.EncoderLayer_0.Dense_0.weight.shape == (512, D_MODEL)
    assert net._Head_0.Dense_1.weight.shape == (512, 512)
    assert net.SqueezeExcitation_0.Dense_0.weight.shape == (D_MODEL // 16, D_MODEL)


def _random_batch(rng: np.random.Generator) -> dict[str, np.ndarray]:
    f32 = np.float32
    return {
        "obs": rng.normal(size=(BATCH, OBS)).astype(f32),
        "action": rng.uniform(-1.0, 1.0, size=(BATCH, ACT)).astype(f32),
        "reward": (rng.normal(size=BATCH) * 30.0).astype(f32),
        "next_obs": rng.normal(size=(BATCH, OBS)).astype(f32),
        "done": (rng.uniform(size=BATCH) < 0.2).astype(f32),
    }


def _assert_agents_close(port: t_sac.SACState, ref: t_sac.SACState, atol: float, what: str):
    for net in ("actor", "critic", "target_critic", "ema_actor"):
        for (name, p), q in zip(getattr(port, net).named_parameters(),
                                getattr(ref, net).parameters(), strict=True):
            np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=atol,
                                       rtol=0.0, err_msg=f"{what}: {net}.{name}")
    for opt in ("actor_opt", "critic_opt"):
        a, b = getattr(port, opt), getattr(ref, opt)
        assert a.count == b.count, f"{what}: {opt}.count"
        for moment in ("mu", "nu"):
            for i, (x, y) in enumerate(zip(getattr(a, moment), getattr(b, moment), strict=True)):
                np.testing.assert_allclose(x.numpy(), y.numpy(), atol=atol, rtol=0.0,
                                           err_msg=f"{what}: {opt}.{moment}[{i}]")
    np.testing.assert_allclose(port.log_alpha.numpy(), ref.log_alpha.numpy(), atol=atol)
    assert port.step == ref.step


@functools.lru_cache(maxsize=1)
def _jax_update():
    j_cfg = j_sac.SACConfig(**SAC)
    return j_cfg, jax.jit(lambda s, b, k: j_sac.update(s, b, k, j_cfg, OBS, ACT))


def test_sac_updates_match_jax():
    (j_cfg, j_update), t_cfg = _jax_update(), t_sac.SACConfig(**SAC)
    j_state = j_sac.init(jax.random.PRNGKey(5), OBS, ACT, j_cfg)
    port = sac_state_from_numpy(np_tree(j_state), t_cfg, OBS, ACT, device="cpu")
    assert isinstance(port.actor, t_tf.TransformerActor)
    rng = np.random.default_rng(6)
    for i in range(UPDATES):
        batch = _random_batch(rng)
        key = jax.random.PRNGKey(200 + i)
        j_state, j_metrics = j_update(j_state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        port, metrics = t_sac.update(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                                     t_cfg, update_draws(key, BATCH, ACT))
    ref = sac_state_from_numpy(np_tree(j_state), t_cfg, OBS, ACT, device="cpu")
    _assert_agents_close(port, ref, 1e-4, f"after {UPDATES} updates")
    assert sorted(metrics) == sorted(j_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(j_metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    # the value head and (over one token) the query and key projections get
    # no gradient on either side: their Adam moments stay zero
    names = [n for n, _ in port.actor.named_parameters()]
    for i, name in enumerate(names):
        idle = "_Head_1." in name or ".query." in name or ".key." in name
        assert (float(port.actor_opt.nu[i].abs().max()) == 0.0) == idle, name


def test_convert_round_trip():
    """Every actor, EMA actor and critic parameter and every Adam moment of a
    JAX transformer SAC state lands on its tensor, in order."""
    (j_cfg, j_update), t_cfg = _jax_update(), t_sac.SACConfig(**SAC)
    j_state = j_sac.init(jax.random.PRNGKey(8), OBS, ACT, j_cfg)
    # one update, so that the moments are not zero
    batch = {k: jnp.asarray(v) for k, v in _random_batch(np.random.default_rng(9)).items()}
    j_state, _ = j_update(j_state, batch, jax.random.PRNGKey(1))
    tree = np_tree(j_state)
    port = sac_state_from_numpy(tree, t_cfg, OBS, ACT, device="cpu")
    want = actor_from_flax(tree.actor_params)
    assert sorted(n for n, _ in port.actor.named_parameters()) == sorted(want)
    for name, p in port.actor.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[name].numpy(), err_msg=name)
    ema = actor_from_flax(tree.ema_actor_params)
    for name, p in port.ema_actor.named_parameters():
        np.testing.assert_array_equal(p.numpy(), ema[name].numpy(), err_msg=name)
    adam = tree.actor_opt[1][0]   # chain(clip, adam): the adam state
    mu = actor_from_flax(adam.mu)
    for (name, _), m in zip(port.actor.named_parameters(), port.actor_opt.mu, strict=True):
        np.testing.assert_array_equal(m.numpy(), mu[name].numpy(), err_msg=name)
    assert port.actor_opt.count == int(adam.count) == 1
    # an attention kernel (d, heads, head_dim) flattens in the port's order
    q = tree.actor_params["params"]["TransformerPolicyNetwork_0"]["EncoderLayer_1"][
        "MultiHeadDotProductAttention_0"]["query"]["kernel"]
    layer = port.actor.TransformerPolicyNetwork_0.EncoderLayer_1.MultiHeadDotProductAttention_0
    np.testing.assert_array_equal(layer.query.weight.detach().numpy().T.reshape(q.shape), q)
    with torch.no_grad():
        mean, _ = port.actor(torch.zeros(2, OBS))
    assert torch.isfinite(mean).all()


def test_transformer_seeded_init_and_select_action():
    cfg = t_sac.SACConfig(**SAC)
    a = t_sac.init(OBS, ACT, cfg, device="cpu", seed=2)
    b = t_sac.init(OBS, ACT, cfg, device="cpu", seed=2)
    for p, q in zip(a.actor.parameters(), b.actor.parameters(), strict=True):
        assert torch.equal(p, q)
    obs = torch.randn(8, OBS, generator=torch.Generator().manual_seed(0))
    act = t_sac.select_action(a.actor, obs, generator=torch.Generator().manual_seed(1))
    assert act.shape == (8, ACT) and bool((act.abs() <= 1.0).all())
    assert len(list(a.actor.parameters())) == 60
