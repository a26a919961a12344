"""The legacy ``SACAgent`` class API over the port's SAC core.

Counterpart of ``tvc_ai_tpu/agents/legacy.py``: a single-env convenience
shell (the surface the export and evaluation scripts read) whose compute is
``agents.sac`` and ``agents.replay``.

- ``SACAgent(obs_dim, action_dim, config=None, seed=0, device="cuda")``
- members: ``actor``, ``critic1``, ``critic2``, ``target_critic1``,
  ``target_critic2`` (the state's modules themselves), ``log_alpha`` (the
  state's tensor), ``replay_buffer`` (supports ``len()``), ``total_steps``,
  ``config``, ``obs_dim``, ``action_dim``, ``state``
- methods: ``select_action(obs, deterministic=False)`` on one unbatched
  observation, returning numpy; ``store_transition(s, a, r, s', done)``;
  ``train() -> dict`` (``{}`` until the buffer holds ``learning_starts``
  and ``batch_size`` rows); ``eval_mode()``; ``save(path)`` / ``load(path)``
  / ``load_state_dict(d)``.

One ``torch.Generator`` stands in for the reference's key, which it splits
on every ``select_action`` and ``train``; the draws may instead be given
(``n_act``; ``sample_idx`` and ``update_draws``). ``save`` writes the
port's own ``torch.save`` file, ``{"state", "obs_dim", "action_dim",
"total_steps"}``. ``read_agent_file`` reads it back, and reads the JAX
package's flax msgpack agent files too: its ``SACAgent.save`` file and the
DAgger students (``{"state": SACState}``), through ``utils.flax_msgpack``.
"""

from __future__ import annotations

import zipfile
from pathlib import Path
from typing import Any

import numpy as np
import torch

from tvc_ai_torch.agents import replay as replay_mod
from tvc_ai_torch.agents import sac as sac_mod
from tvc_ai_torch.agents.sac import SACConfig
from tvc_ai_torch.utils import flax_msgpack
from tvc_ai_torch.utils.checkpoint import load_state, state_of
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device

__all__ = ["SACAgent", "SACConfig", "fit_ema", "read_agent_file"]

PAYLOAD_KEYS = {"state", "obs_dim", "action_dim", "total_steps"}


def read_agent_file(path: str | Path, device: str | torch.device = "cpu") -> dict[str, Any]:
    """The payload of an agent file, ``{"state", "obs_dim", "action_dim",
    "total_steps"}`` with ``state`` a ``SACState`` as ``state_of`` gives it,
    its tensors on ``device``: this package's ``SACAgent.save`` file (a
    ``torch.save`` zip), or a flax msgpack agent file of the JAX package
    (``_flax_agent_payload``). Anything else raises ``ValueError``."""
    path = Path(path)
    if flax_msgpack.is_flax_msgpack(path):
        return _flax_agent_payload(path, device)
    if not zipfile.is_zipfile(path):
        raise ValueError(f"{path}: neither a SACAgent.save file of this package (a zip) nor "
                         "a flax msgpack agent file of the JAX package")
    payload = torch.load(path, map_location=device, weights_only=True)
    if not isinstance(payload, dict) or set(payload) != PAYLOAD_KEYS:
        raise ValueError(f"{path}: not a SACAgent.save payload "
                         f"(keys {sorted(payload) if isinstance(payload, dict) else type(payload)})")
    return payload


def _flax_agent_payload(path: Path, device: str | torch.device) -> dict[str, Any]:
    """A flax msgpack agent file as ``read_agent_file``'s payload. Its
    ``state`` (the whole file where it has none, as the reference's
    ``load_agent_state`` reads it) becomes a ``SACState`` of the widths its
    actor's kernels give; ``obs_dim`` and ``action_dim`` come from the file
    where it carries them (the legacy ``SACAgent.save`` does, a DAgger student
    does not) and must agree with the kernels; ``total_steps`` defaults to 0."""
    from tvc_ai_torch.convert import actor_dims, sac_state_from_state_dict

    raw = flax_msgpack.load(path)
    tree = raw.get("state", raw) if isinstance(raw, dict) else None
    if not isinstance(tree, dict) or "actor_params" not in tree:
        raise ValueError(f"{path}: a flax msgpack file that holds no SACState (no actor_params)")
    obs_dim, _, action_dim = actor_dims(tree["actor_params"])
    for name, inferred in (("obs_dim", obs_dim), ("action_dim", action_dim)):
        if int(raw.get(name, inferred)) != inferred:
            raise ValueError(f"{path}: {name} {raw[name]} but the actor's kernels give {inferred}")
    state = sac_state_from_state_dict(tree, resolve_device(device))
    return {"state": state_of(state), "obs_dim": obs_dim, "action_dim": action_dim,
            "total_steps": int(raw.get("total_steps", 0))}


def fit_ema(template: sac_mod.SACState, state: dict[str, Any]) -> dict[str, Any]:
    """``state`` (``read_agent_file``'s) without its EMA actor where
    ``template``'s config keeps none: nothing reads it there (the reference
    evaluates the live actor then, ``eval_actor_view``)."""
    if template.ema_actor is None and state.get("ema_actor") is not None:
        return {**state, "ema_actor": None}
    return state


class _BufferView:
    def __init__(self, owner: "SACAgent"):
        self._owner = owner

    def __len__(self) -> int:
        return self._owner.buffer.size


class SACAgent:
    """Single-env SAC agent (the legacy behavioural contract)."""

    def __init__(
        self,
        obs_dim: int,
        action_dim: int,
        config: SACConfig | None = None,
        seed: int = 0,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        self.obs_dim = int(obs_dim)
        self.action_dim = int(action_dim)
        self.config = config or SACConfig()
        self.total_steps = 0
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = sac_mod.init(self.obs_dim, self.action_dim, self.config, self.device, seed)
        example = {
            "obs": torch.zeros(self.obs_dim),
            "action": torch.zeros(self.action_dim),
            "reward": torch.zeros(()),
            "next_obs": torch.zeros(self.obs_dim),
            "done": torch.zeros(()),
        }
        self.buffer = replay_mod.ReplayBuffer.create(int(self.config.buffer_size), example,
                                                     self.device)
        self.replay_buffer = _BufferView(self)

    # the state's own modules and tensors (``update`` steps them in place)
    @property
    def actor(self) -> torch.nn.Module:
        return self.state.actor

    @property
    def critic1(self) -> torch.nn.Module:
        return self.state.critic.q1

    @property
    def critic2(self) -> torch.nn.Module:
        return self.state.critic.q2

    @property
    def target_critic1(self) -> torch.nn.Module:
        return self.state.target_critic.q1

    @property
    def target_critic2(self) -> torch.nn.Module:
        return self.state.target_critic.q2

    @property
    def log_alpha(self) -> torch.Tensor:
        return self.state.log_alpha

    def _row(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32), device=self.device)[None]

    def select_action(self, obs, deterministic: bool = False,
                      n_act: torch.Tensor | None = None) -> np.ndarray:
        """The action for one observation; ``n_act`` (action_dim,) is the
        exploration noise, drawn from the generator when not given."""
        noise = None if n_act is None else n_act.reshape(1, -1).to(self.device)
        action = sac_mod.select_action(self.state.actor, self._row(obs), noise, deterministic,
                                       self.generator)
        return action[0].cpu().numpy()

    def store_transition(self, obs, action, reward, next_obs, done) -> None:
        self.buffer = replay_mod.add_batch(self.buffer, {
            "obs": self._row(obs),
            "action": self._row(action),
            "reward": self._row(reward),
            "next_obs": self._row(next_obs),
            "done": self._row(float(bool(done))),
        })
        self.total_steps += 1

    def train(self, sample_idx: torch.Tensor | None = None,
              update_draws: sac_mod.UpdateDraws | None = None) -> dict[str, float]:
        """One gradient step once the buffer is warm, else ``{}``."""
        size = self.buffer.size
        if size < self.config.learning_starts or size < self.config.batch_size:
            return {}
        idx = None if sample_idx is None else sample_idx.to(self.device)
        batch = replay_mod.sample(self.buffer, self.config.batch_size, idx, self.generator)
        if update_draws is not None:
            update_draws = sac_mod.UpdateDraws(n_next=update_draws.n_next.to(self.device),
                                               n_pi=update_draws.n_pi.to(self.device))
        self.state, metrics = sac_mod.update(self.state, batch, self.config, update_draws,
                                             self.generator)
        return {k: float(v) for k, v in metrics.items()}

    def eval_mode(self) -> None:
        for module in (self.actor, self.critic1, self.critic2):
            module.eval()

    def save(self, path) -> None:
        """Write the learnable state (``torch.save``)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({
            "state": state_of(self.state),
            "obs_dim": self.obs_dim,
            "action_dim": self.action_dim,
            "total_steps": self.total_steps,
        }, path)

    def load(self, path) -> None:
        """Restore the state and ``total_steps`` from this package's file or
        the JAX package's msgpack one (``read_agent_file``)."""
        payload = read_agent_file(path, self.device)
        self.load_state_dict(payload["state"])
        self.total_steps = int(payload["total_steps"])

    def load_state_dict(self, state_dict) -> None:
        self.state = load_state(self.state, fit_ema(self.state, state_dict))
