"""The learned safety correction head of tvc_ai_torch against the JAX package
(CPU).

The flax ``SafetyCorrectionNet``'s parameters are carried across with
``convert.safety_net_from_flax``; both sides then see the same seeded numpy
observations and proposals, a mix of rows that violate a constraint (tilt,
angular rate, effort) and rows that do not. Bars: the forward 1e-6, the loss
1e-6, every parameter's gradient of ``correction_loss`` 1e-5.

At exactly ±1, ``jnp.clip``'s gradient is 0.5 (it is ``minimum(maximum(x,
lo), hi)``, and a tie passes half to each side); ``torch.clamp`` would pass
1. The port computes the clip as jnp does, and a case with the last layer's
outputs pinned at ±1 holds the gradient there.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_parity_utils import np_tree
from tvc_ai_torch.convert import safety_net_from_flax
from tvc_ai_torch.models import safety as t_safety
from tvc_ai_tpu.models import safety as j_safety

torch.set_num_threads(1)
B = 96
CLOSE = dict(atol=1e-6, rtol=1e-6)
GRAD = dict(atol=1e-5, rtol=1e-5)
C = dict(max_tilt=0.52, max_angular_velocity=5.0, max_control_effort=1.0)


def _inputs(seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(B, 10)).astype(np.float32)
    obs[:, :4] /= np.linalg.norm(obs[:, :4], axis=1, keepdims=True)
    # upright quaternions for half the rows, so some rows violate nothing
    obs[: B // 2, :4] = [0.0, 0.0, 0.0, 1.0]
    obs[: B // 2, :4] += 0.05 * rng.normal(size=(B // 2, 4)).astype(np.float32)
    obs[:, 4:7] *= 3.0
    act = rng.uniform(-0.9, 0.9, size=(B, 2)).astype(np.float32)
    return obs, act


def _pair(seed: int, pin: bool = False):
    net = j_safety.SafetyCorrectionNet()
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, 10)), jnp.zeros((1, 2)))
    if pin:   # the last layer outputs exactly (1, -1) on every row
        dense = params["params"]["Dense_2"]
        params = {"params": dict(params["params"], Dense_2={
            "kernel": jnp.zeros_like(dense["kernel"]), "bias": jnp.asarray([1.0, -1.0])})}
    port = t_safety.SafetyCorrectionNet(device="cpu")
    port.load_state_dict(safety_net_from_flax(np_tree(params)))
    return net, params, port


def _loss_and_grads(net, params, port, obs, act):
    j_c, t_c = j_safety.SafetyConstraints(**C), t_safety.SafetyConstraints(**C)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: j_safety.correction_loss(net, p, jnp.asarray(obs), jnp.asarray(act), j_c))(
        params)
    t_loss = t_safety.correction_loss(port, torch.from_numpy(obs), torch.from_numpy(act), t_c)
    t_grads = torch.autograd.grad(t_loss, list(port.parameters()))
    return j_loss, np_tree(j_grads)["params"], t_loss, dict(zip(
        (n for n, _ in port.named_parameters()), t_grads))


def _assert_grads_close(j_grads, t_grads) -> None:
    for name, g in t_grads.items():
        layer, kind = name.split(".")
        want = j_grads[layer]["kernel"].T if kind == "weight" else j_grads[layer]["bias"]
        np.testing.assert_allclose(g.numpy(), want, **GRAD, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_loss_and_gradients_match_jax(seed):
    net, params, port = _pair(seed)
    obs, act = _inputs(seed + 10)
    mask = np.asarray(j_safety.violations(jnp.asarray(obs), jnp.asarray(act),
                                          j_safety.SafetyConstraints(**C)))
    assert 0 < mask.sum() < B   # both terms of the loss take part
    want = np.asarray(net.apply(params, jnp.asarray(obs), jnp.asarray(act)))
    got = port(torch.from_numpy(obs), torch.from_numpy(act)).detach().numpy()
    np.testing.assert_allclose(got, want, **CLOSE)
    j_loss, j_grads, t_loss, t_grads = _loss_and_grads(net, params, port, obs, act)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), **CLOSE)
    _assert_grads_close(j_grads, t_grads)


def test_gradient_at_the_clip_boundary_matches_jax():
    net, params, port = _pair(3, pin=True)
    obs, act = _inputs(13)
    out = port(torch.from_numpy(obs), torch.from_numpy(act)).detach()
    assert torch.equal(out, torch.tensor([1.0, -1.0]).expand(B, 2))
    j_loss, j_grads, t_loss, t_grads = _loss_and_grads(net, params, port, obs, act)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), **CLOSE)
    _assert_grads_close(j_grads, t_grads)
    # half the gradient passes the tie: d loss / d out, halved
    x = out.clone().requires_grad_(True)
    target = t_safety.analytic_safe_action(torch.from_numpy(obs), torch.from_numpy(act),
                                           t_safety.SafetyConstraints(**C))
    mask = t_safety.violations(torch.from_numpy(obs), torch.from_numpy(act),
                               t_safety.SafetyConstraints(**C)).float()[:, None]
    loss = torch.mean(torch.sum(mask * (x - target) ** 2 + 0.1 * (1 - mask)
                                * (x - torch.from_numpy(act)) ** 2, dim=-1))
    (d_out,) = torch.autograd.grad(loss, [x])
    torch.testing.assert_close(t_grads["Dense_2.bias"], 0.5 * d_out.sum(0), atol=1e-6, rtol=1e-6)
    assert t_grads["Dense_2.bias"].abs().min() > 0


def test_port_init_has_the_flax_layout():
    net = j_safety.SafetyCorrectionNet()
    params = np_tree(net.init(jax.random.PRNGKey(0), jnp.zeros((1, 10)), jnp.zeros((1, 2))))
    port = t_safety.SafetyCorrectionNet(device="cpu", seed=1)
    want = {k: tuple(v.shape) for k, v in safety_net_from_flax(params).items()}
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want
    assert all(not p.detach().any() for n, p in port.named_parameters() if "bias" in n)
    other = t_safety.SafetyCorrectionNet(device="cpu", seed=2)
    assert not torch.equal(port.Dense_0.weight, other.Dense_0.weight)
