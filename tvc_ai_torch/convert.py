"""Carry weights, optimizer, replay, env and loop state across from the JAX package
(the SAC loop's carry with its ICM, RND and high-level state, a population's
carries, the ensemble's with its TD3 and PPO members, and the safety
correction net).

The inputs are plain host data: nested dicts, tuples (or attribute objects)
whose leaves are numpy arrays or anything ``numpy.asarray`` takes. Nothing
here imports JAX, flax or optax; a caller holding JAX pytrees maps them to
numpy first (``jax.tree.map(np.asarray, tree)`` keeps optax's named tuples).
The learners' states are also taken in flax's state-dict form, as a flax
msgpack file holds them (``utils.flax_msgpack``): a tuple there is a dict
keyed "0".."n-1", a named tuple a dict of its fields, an absent EMA actor
``None`` and ``step`` a 0-d array.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from tvc_ai_torch.agents import ensemble, optim, ppo, sac, td3
from tvc_ai_torch.agents.replay import ReplayBuffer
from tvc_ai_torch.env.types import (
    ACTION_DIM,
    DomainParams,
    EnvParams,
    EnvState,
    RandomizationConfig,
    RewardConfig,
    SuccessConfig,
    TerminationConfig,
)
from tvc_ai_torch.models import curiosity as icm_mod
from tvc_ai_torch.models import hierarchical as hier_mod
from tvc_ai_torch.models import rnd as rnd_mod
from tvc_ai_torch.physics.types import RigidBodyState, RocketParams
from tvc_ai_torch.training.loop import TrainCarry, TrainLoopConfig, policy_obs_dim
from tvc_ai_torch.training.population import PopulationConfig, loop_config
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device


def _get(obj: Any, name: str) -> Any:
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _f32(x: Any) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _dense_layers(params: Mapping[str, Any], prefix: str = "") -> dict[str, torch.Tensor]:
    """State dict of the flax layers in ``params`` (nested modules joined
    with "."), by the flax names. Accepts the variables dict (``{"params":
    {...}}``) or its inner dict.

    - ``Dense``: kernel (in, out) → ``nn.Linear.weight`` (out, in);
    - ``DenseGeneral`` of attention: a q/k/v kernel (in, heads, head_dim)
      with bias (heads, head_dim), or an out kernel (heads, head_dim, out),
      each → the ``nn.Linear`` over the flattened heads;
    - ``LayerNorm``: scale → ``weight``, bias → ``bias``.
    """
    if "params" in params:
        params = params["params"]
    state = {}
    for name, sub in params.items():
        if "kernel" in sub:
            kernel, bias = _f32(sub["kernel"]), _f32(sub["bias"])
            if kernel.ndim == 3 and bias.ndim == 2:    # (in, heads, head_dim)
                kernel = kernel.reshape(kernel.shape[0], -1)
            elif kernel.ndim == 3:                     # (heads, head_dim, out)
                kernel = kernel.reshape(-1, kernel.shape[-1])
            state[f"{prefix}{name}.weight"] = torch.tensor(np.ascontiguousarray(kernel.T))
            state[f"{prefix}{name}.bias"] = torch.tensor(bias.reshape(-1))
        elif "scale" in sub:
            state[f"{prefix}{name}.weight"] = torch.tensor(_f32(sub["scale"]))
            state[f"{prefix}{name}.bias"] = torch.tensor(_f32(sub["bias"]))
        else:
            state.update(_dense_layers(sub, f"{prefix}{name}."))
    return state


def actor_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``GaussianActor`` or ``TransformerActor`` state dict from flax actor params."""
    return _dense_layers(params)


def critic_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``TwinQ`` state dict (``q1.hidden_0.weight``, …) from flax critic params."""
    return _dense_layers(params)


def deterministic_actor_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``DeterministicActor`` state dict (``action_head``) from flax TD3 actor params."""
    return _dense_layers(params)


def value_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``ValueNetwork`` state dict (``v_head``) from flax value params."""
    return _dense_layers(params)


def safety_net_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``SafetyCorrectionNet`` state dict (``Dense_0``..``Dense_2``) from flax params."""
    return _dense_layers(params)


def theta_net_from_flax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """``training.theta_student.ThetaNet`` state dict (``Dense_0``, …) from
    flax θ-net params."""
    return _dense_layers(params)


def _tensor(x: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device)


def env_state_from_numpy(state: Any, device: str | torch.device = DEFAULT_DEVICE) -> EnvState:
    """``EnvState`` from a batched JAX ``EnvState`` mapped to numpy.

    The JAX state's ``key`` has no counterpart here and is dropped;
    ``prev_imu`` (held only with sensor dropout on) is carried when present.
    """
    dev = resolve_device(device)
    body, dr = _get(state, "body"), _get(state, "dr")
    fields = {}
    for f in dataclasses.fields(EnvState):
        if f.name == "body":
            fields["body"] = RigidBodyState(
                **{g.name: _tensor(_get(body, g.name), dev)
                   for g in dataclasses.fields(RigidBodyState)}
            )
        elif f.name == "dr":
            fields["dr"] = DomainParams(
                **{g.name: _tensor(_get(dr, g.name), dev)
                   for g in dataclasses.fields(DomainParams)}
            )
        elif f.name == "prev_imu":
            prev = _get(state, f.name) if _has(state, f.name) else None
            fields[f.name] = None if prev is None else _tensor(prev, dev)
        else:
            fields[f.name] = _tensor(_get(state, f.name), dev)
    return EnvState(**fields)


def _scalar(x: Any, like: Any) -> Any:
    if isinstance(like, bool):
        return bool(np.asarray(x))
    if isinstance(like, int):
        return int(np.asarray(x))
    if isinstance(like, tuple):
        return tuple(float(v) for v in np.asarray(x, dtype=np.float32).reshape(-1))
    return float(np.asarray(x))


def _config(cls: type, src: Any) -> Any:
    default = cls()
    return cls(**{
        f.name: _scalar(_get(src, f.name), getattr(default, f.name))
        for f in dataclasses.fields(cls)
    })


def env_params_from_numpy(params: Any) -> EnvParams:
    """``EnvParams`` from a JAX ``EnvParams`` (leaves as arrays or scalars)."""
    subs = {
        "rocket": RocketParams,
        "randomization": RandomizationConfig,
        "success": SuccessConfig,
        "reward": RewardConfig,
        "termination": TerminationConfig,
    }
    default = EnvParams()
    fields = {}
    for f in dataclasses.fields(EnvParams):
        src = _get(params, f.name)
        if f.name in subs:
            fields[f.name] = _config(subs[f.name], src)
        else:
            fields[f.name] = _scalar(src, getattr(default, f.name))
    return EnvParams(**fields)


def _has(obj: Any, name: str) -> bool:
    return name in obj if isinstance(obj, Mapping) else hasattr(obj, name)


def _children(tree: Any) -> tuple | None:
    """The entries of a tuple or list, or of flax's state-dict form of one (a
    dict keyed "0".."n-1"), in order; ``None`` for anything else."""
    if isinstance(tree, (tuple, list)):
        return tuple(tree)
    if isinstance(tree, Mapping) and set(tree) == {str(i) for i in range(len(tree))}:
        return tuple(tree[str(i)] for i in range(len(tree)))
    return None


def _find_adam(opt_state: Any) -> Any:
    """The ``ScaleByAdamState`` (mu, nu, count) inside an optax chain's state."""
    if all(_has(opt_state, k) for k in ("mu", "nu", "count")):
        return opt_state
    for child in _children(opt_state) or ():
        found = _find_adam(child)
        if found is not None:
            return found
    return None


def _adam_state(opt_state: Any, module: torch.nn.Module | tuple[torch.nn.Module, ...],
                device: torch.device, device_count: bool = False) -> optim.AdamState:
    """The Adam state of one module's parameters, or of a tuple of modules'
    whose optimizer holds a tuple of trees (PPO's (actor, value)), in the
    modules' parameter order. ``device_count`` keeps the count as a 0-dim
    int32 device tensor (the high level's) instead of a host int."""
    adam = _find_adam(opt_state)
    if adam is None:
        raise ValueError("no Adam state (mu, nu, count) in the optimizer state")
    single = isinstance(module, torch.nn.Module)
    modules = (module,) if single else tuple(module)
    moments = []
    for tree in (_get(adam, "mu"), _get(adam, "nu")):
        trees = (tree,) if single else _children(tree)
        if trees is None:
            raise ValueError(f"an Adam moment over {len(modules)} modules that is not a tuple")
        moments.append([])
        for mod, sub in zip(modules, trees, strict=True):
            state = _dense_layers(sub)
            moments[-1] += [state[name].to(device) for name, _ in mod.named_parameters()]
    count = int(np.asarray(_get(adam, "count")))
    if device_count:
        count = torch.tensor(count, dtype=torch.int32, device=device)
    return optim.AdamState(mu=moments[0], nu=moments[1], count=count)


def _scalar_adam_state(opt_state: Any, device: torch.device) -> optim.AdamState:
    adam = _find_adam(opt_state)
    return optim.AdamState(
        mu=[_tensor(_get(adam, "mu"), device)], nu=[_tensor(_get(adam, "nu"), device)],
        count=int(np.asarray(_get(adam, "count"))),
    )


def sac_state_from_numpy(
    state: Any,
    cfg: sac.SACConfig,
    obs_dim: int,
    action_dim: int,
    device: str | torch.device = DEFAULT_DEVICE,
) -> sac.SACState:
    """``SACState`` from a JAX ``SACState`` mapped to numpy: the actor,
    critic, target critic and EMA actor parameters, ``log_alpha``, the three
    optax states (``mu``/``nu``/``count`` from inside ``chain(clip,
    adam(schedule))`` and from the temperature's ``adam``) and ``step``."""
    dev = resolve_device(device)
    agent = sac.init(obs_dim, action_dim, cfg, dev)
    agent.actor.load_state_dict(actor_from_flax(_get(state, "actor_params")))
    agent.critic.load_state_dict(critic_from_flax(_get(state, "critic_params")))
    agent.target_critic.load_state_dict(critic_from_flax(_get(state, "target_critic_params")))
    ema = _get(state, "ema_actor_params")
    if (ema is None) != (agent.ema_actor is None):
        raise ValueError("the EMA actor is present in one of the state and the config only")
    if ema is not None:
        agent.ema_actor.load_state_dict(actor_from_flax(ema))
    agent.log_alpha = _tensor(_get(state, "log_alpha"), dev)
    agent.actor_opt = _adam_state(_get(state, "actor_opt"), agent.actor, dev)
    agent.critic_opt = _adam_state(_get(state, "critic_opt"), agent.critic, dev)
    agent.alpha_opt = _scalar_adam_state(_get(state, "alpha_opt"), dev)
    agent.step = int(np.asarray(_get(state, "step")))
    return agent


def actor_dims(params: Mapping[str, Any]) -> tuple[int, tuple[int, ...], int]:
    """``(obs_dim, hidden_dims, action_dim)`` of a flax MLP ``GaussianActor``
    from its kernels' shapes (``hidden_{i}``, ``mean_head``)."""
    if "params" in params:
        params = params["params"]
    kernels = []
    while f"hidden_{len(kernels)}" in params:
        kernels.append(np.shape(params[f"hidden_{len(kernels)}"]["kernel"]))
    if not kernels or "mean_head" not in params:
        raise ValueError(f"not the params of an MLP GaussianActor (layers {sorted(params)})")
    return kernels[0][0], tuple(k[1] for k in kernels), np.shape(params["mean_head"]["kernel"])[1]


def sac_state_from_state_dict(state: Mapping[str, Any],
                              device: str | torch.device = DEFAULT_DEVICE) -> sac.SACState:
    """``SACState`` from a JAX ``SACState`` whose config is not at hand (a
    flax msgpack file's): the widths from the actor's kernels
    (``actor_dims``), the EMA actor where the state holds one."""
    obs_dim, hidden, action_dim = actor_dims(_get(state, "actor_params"))
    ema = _get(state, "ema_actor_params")
    agent = sac_state_from_numpy({**state, "ema_actor_params": None},
                                 sac.SACConfig(hidden_dims=hidden), obs_dim, action_dim, device)
    if ema is not None:
        agent.ema_actor = sac.frozen_copy(agent.actor)
        agent.ema_actor.load_state_dict(actor_from_flax(ema))
    return agent


def replay_from_numpy(buffer: Any, device: str | torch.device = DEFAULT_DEVICE) -> ReplayBuffer:
    """``ReplayBuffer`` from a JAX ``ReplayBuffer`` mapped to numpy; ``ptr``
    and ``size`` become host ints. The static ``capacity``, absent from
    flax's state-dict form, is then the rows of the data."""
    dev = resolve_device(device)
    data = {k: _tensor(v, dev) for k, v in _get(buffer, "data").items()}
    return ReplayBuffer(
        data=data,
        ptr=int(np.asarray(_get(buffer, "ptr"))),
        size=int(np.asarray(_get(buffer, "size"))),
        capacity=(int(_get(buffer, "capacity")) if _has(buffer, "capacity")
                  else next(iter(data.values())).shape[0]),
    )


def curiosity_state_from_numpy(state: Any, cfg: icm_mod.CuriosityConfig,
                               device: str | torch.device = DEFAULT_DEVICE
                               ) -> icm_mod.CuriosityState:
    """``CuriosityState`` from a JAX ``CuriosityState`` mapped to numpy."""
    dev = resolve_device(device)
    out = icm_mod.init(cfg, dev)
    out.nets.load_state_dict(_dense_layers(_get(state, "params")))
    out.opt = _adam_state(_get(state, "opt_state"), out.nets, dev)
    out.step = int(np.asarray(_get(state, "step")))
    return out


def rnd_state_from_numpy(state: Any, cfg: rnd_mod.RNDConfig,
                         device: str | torch.device = DEFAULT_DEVICE) -> rnd_mod.RNDState:
    """``RNDState`` from a JAX ``RNDState`` mapped to numpy."""
    dev = resolve_device(device)
    out = rnd_mod.init(cfg, dev)
    out.target.load_state_dict(_dense_layers(_get(state, "target_params")))
    out.predictor.load_state_dict(_dense_layers(_get(state, "predictor_params")))
    out.opt = _adam_state(_get(state, "opt_state"), out.predictor, dev)
    out.step = int(np.asarray(_get(state, "step")))
    out.bonus_mean = _tensor(_get(state, "bonus_mean"), dev)
    out.bonus_var = _tensor(_get(state, "bonus_var"), dev)
    return out


def high_level_state_from_numpy(state: Any, obs_dim: int, cfg: hier_mod.HierarchicalConfig,
                                device: str | torch.device = DEFAULT_DEVICE
                                ) -> hier_mod.HighLevelState:
    """``HighLevelState`` from a JAX ``HighLevelState`` mapped to numpy; the
    Adam count and ``step`` stay device tensors."""
    dev = resolve_device(device)
    out = hier_mod.init_high(obs_dim, cfg, dev)
    out.policy.load_state_dict(_dense_layers(_get(state, "params")))
    out.opt = _adam_state(_get(state, "opt_state"), out.policy, dev, device_count=True)
    out.baseline = _tensor(_get(state, "baseline"), dev)
    out.step = _tensor(_get(state, "step"), dev)
    return out


def train_carry_from_numpy(
    carry: Any,
    sac_cfg: sac.SACConfig,
    loop_cfg: TrainLoopConfig,
    device: str | torch.device = DEFAULT_DEVICE,
    seed: int = 0,
) -> TrainCarry:
    """``TrainCarry`` from a JAX ``TrainCarry`` mapped to numpy, with the
    ICM, RND and high-level states and the goal fields when present. The key
    becomes a generator seeded with ``seed``; ``env_steps_host`` is
    ``env_steps[0]``."""
    dev = resolve_device(device)
    window = _get(carry, "obs_window")
    demo = _get(carry, "demo_buffer")
    counters = ("env_steps", "episodes", "successes", "ep_return", "ep_length", "return_sum",
                "length_sum", "ep_ring_return", "ep_ring_length", "ep_ring_success",
                "ep_ring_seq", "ep_ring_ptr")
    icm, rnd, hier = (_get(carry, name) for name in ("icm", "rnd", "hier"))
    optional = {name: None if _get(carry, name) is None else _tensor(_get(carry, name), dev)
                for name in ("goal", "goal_obs", "ep_ring_goal", "ep_ring_goal_obs")}
    env_steps = np.asarray(_get(carry, "env_steps"))
    return TrainCarry(
        env_states=env_state_from_numpy(_get(carry, "env_states"), dev),
        obs=_tensor(_get(carry, "obs"), dev),
        agent=sac_state_from_numpy(_get(carry, "agent"), sac_cfg, policy_obs_dim(loop_cfg),
                                   loop_cfg.action_dim, dev),
        buffer=replay_from_numpy(_get(carry, "buffer"), dev),
        generator=torch.Generator(device=dev).manual_seed(seed),
        obs_window=None if window is None else _tensor(window, dev),
        demo_buffer=None if demo is None else replay_from_numpy(demo, dev),
        icm=None if icm is None else curiosity_state_from_numpy(icm, loop_cfg.curiosity, dev),
        rnd=None if rnd is None else rnd_state_from_numpy(rnd, loop_cfg.rnd, dev),
        hier=None if hier is None else high_level_state_from_numpy(
            hier, loop_cfg.obs_dim, loop_cfg.hierarchical, dev),
        env_steps_host=int(env_steps.reshape(-1)[0]) if env_steps.size else 0,
        **optional,
        **{name: _tensor(_get(carry, name), dev) for name in counters},
    )


def _agent_slice(tree: Any, i: int) -> Any:
    """Agent ``i`` of a tree whose array leaves carry a leading agent axis;
    scalar leaves (static fields such as a replay's ``capacity``) stay."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: _agent_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # optax's named tuples
        return type(tree)(*(_agent_slice(v, i) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_agent_slice(v, i) for v in tree)
    if dataclasses.is_dataclass(tree):
        return {f.name: _agent_slice(getattr(tree, f.name), i) for f in dataclasses.fields(tree)}
    a = np.asarray(tree)
    return a[i] if a.ndim >= 1 else tree


def population_from_numpy(
    carry: Any,
    sac_cfg: sac.SACConfig,
    pop_cfg: PopulationConfig,
    device: str | torch.device = DEFAULT_DEVICE,
    seed: int = 0,
) -> list[TrainCarry]:
    """One ``TrainCarry`` per agent from a JAX population carry (every leaf
    with a leading agent axis P) mapped to numpy; agent ``i``'s generator is
    seeded with ``seed + i``."""
    loop_cfg = loop_config(pop_cfg)
    return [train_carry_from_numpy(_agent_slice(carry, i), sac_cfg, loop_cfg, device, seed + i)
            for i in range(pop_cfg.num_agents)]


def td3_state_from_numpy(
    state: Any,
    cfg: td3.TD3Config,
    obs_dim: int,
    action_dim: int,
    device: str | torch.device = DEFAULT_DEVICE,
) -> td3.TD3State:
    """``TD3State`` from a JAX ``TD3State`` mapped to numpy: the actor,
    critic and both targets, the two optax states and ``step``."""
    dev = resolve_device(device)
    out = td3.init(obs_dim, action_dim, cfg, dev)
    out.actor.load_state_dict(deterministic_actor_from_flax(_get(state, "actor_params")))
    out.critic.load_state_dict(critic_from_flax(_get(state, "critic_params")))
    out.target_actor.load_state_dict(
        deterministic_actor_from_flax(_get(state, "target_actor_params")))
    out.target_critic.load_state_dict(critic_from_flax(_get(state, "target_critic_params")))
    out.actor_opt = _adam_state(_get(state, "actor_opt"), out.actor, dev)
    out.critic_opt = _adam_state(_get(state, "critic_opt"), out.critic, dev)
    out.step = int(np.asarray(_get(state, "step")))
    return out


def ppo_state_from_numpy(
    state: Any,
    cfg: ppo.PPOConfig,
    obs_dim: int,
    action_dim: int,
    device: str | torch.device = DEFAULT_DEVICE,
) -> ppo.PPOState:
    """``PPOState`` from a JAX ``PPOState`` mapped to numpy: the actor, the
    value network, the one optax state over both and ``step``."""
    dev = resolve_device(device)
    out = ppo.init(obs_dim, action_dim, cfg, dev)
    out.actor.load_state_dict(actor_from_flax(_get(state, "actor_params")))
    out.value.load_state_dict(value_from_flax(_get(state, "value_params")))
    out.opt = _adam_state(_get(state, "opt_state"), (out.actor, out.value), dev)
    out.step = int(np.asarray(_get(state, "step")))
    return out


def ensemble_carry_from_numpy(
    carry: Any,
    cfg: ensemble.EnsembleConfig,
    device: str | torch.device = DEFAULT_DEVICE,
    seed: int = 0,
) -> ensemble.EnsembleCarry:
    """``EnsembleCarry`` from a JAX ``EnsembleCarry`` mapped to numpy. The
    key becomes a generator seeded with ``seed``."""
    dev = resolve_device(device)
    obs = _get(carry, "obs")
    obs_dim, action_dim = np.shape(obs)[-1], ACTION_DIM
    counters = ("env_steps", "episodes", "successes", "ep_return", "return_sum", "length_sum",
                "ep_length")
    return ensemble.EnsembleCarry(
        env_states=env_state_from_numpy(_get(carry, "env_states"), dev),
        obs=_tensor(obs, dev),
        sac=sac_state_from_numpy(_get(carry, "sac"), cfg.sac, obs_dim, action_dim, dev),
        td3=td3_state_from_numpy(_get(carry, "td3"), cfg.td3, obs_dim, action_dim, dev),
        ppo=ppo_state_from_numpy(_get(carry, "ppo"), cfg.ppo, obs_dim, action_dim, dev),
        buffer=replay_from_numpy(_get(carry, "buffer"), dev),
        generator=torch.Generator(device=dev).manual_seed(seed),
        **{name: _tensor(_get(carry, name), dev) for name in counters},
    )
