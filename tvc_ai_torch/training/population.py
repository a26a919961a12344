"""Population training: P independent SAC agents, each with its own env group.

Counterpart of ``tvc_ai_tpu/training/population.py``. The reference gives
every leaf of one ``TrainCarry`` a leading agent axis and vmaps the train
iteration over it. The port's iteration steps its modules and replay in
place, keeps host-int counters and launches K1 through ctypes, so a
population here is a list of P ``TrainCarry``s, and one population
iteration runs ``training.loop.make_train_iteration`` on each agent in turn;
per-agent metrics are stacked to shape (P,).

``clone_winners`` is the exploit step: the bottom ``fraction`` of agents
take a deep copy of the agent state (networks, optimizer moments and counts,
temperature, EMA actor) of agents drawn from the top ``fraction``. Env
state, replay, counters and the generator stay with the loser, and no agent
shares a module or tensor with another afterwards: under in-place updates a
shared one would be stepped by both.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Sequence

import torch

from tvc_ai_torch.agents import sac as sac_mod
from tvc_ai_torch.env.rocket_env import ResetDraws
from tvc_ai_torch.env.types import EnvParams
from tvc_ai_torch.training import loop as loop_mod
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    num_agents: int = 4
    envs_per_agent: int = 128
    rollout_steps: int = 64
    updates_per_step: int = 1


def loop_config(pop_cfg: PopulationConfig) -> loop_mod.TrainLoopConfig:
    """Each agent's loop: its env group, the population's cadence, the
    loop's other defaults."""
    return loop_mod.TrainLoopConfig(
        num_envs=pop_cfg.envs_per_agent,
        rollout_steps=pop_cfg.rollout_steps,
        updates_per_step=pop_cfg.updates_per_step,
    )


def init_population(
    env_params: EnvParams,
    sac_cfg: sac_mod.SACConfig,
    pop_cfg: PopulationConfig,
    device: str | torch.device = DEFAULT_DEVICE,
    seed: int = 0,
    reset_draws: Sequence[ResetDraws] | None = None,
) -> list[loop_mod.TrainCarry]:
    """P carries from P distinct seeds drawn from ``seed`` (the reference
    splits its key P ways); ``reset_draws`` gives each agent's env reset."""
    dev = resolve_device(device)
    seeds = torch.randint(0, 2**31 - 1, (pop_cfg.num_agents,),
                          generator=torch.Generator().manual_seed(seed)).tolist()
    loop_cfg = loop_config(pop_cfg)
    return [
        loop_mod.init_carry(env_params, sac_cfg, loop_cfg, dev, s,
                            None if reset_draws is None else reset_draws[i])
        for i, s in enumerate(seeds)
    ]


def make_population_iteration(sac_cfg: sac_mod.SACConfig, pop_cfg: PopulationConfig):
    """``(carries, env_params, draws=None) -> (carries, metrics)``: one train
    iteration per agent; ``draws[i]`` is agent i's ``IterDraws`` list; each
    metric is a (P,) device tensor."""
    iteration = loop_mod.make_train_iteration(sac_cfg, loop_config(pop_cfg))

    def population_iteration(
        carries: Sequence[loop_mod.TrainCarry],
        env_params: EnvParams,
        draws: Sequence[Sequence[loop_mod.IterDraws]] | None = None,
    ) -> tuple[list[loop_mod.TrainCarry], dict[str, torch.Tensor]]:
        if len(carries) != pop_cfg.num_agents:
            raise ValueError(f"{len(carries)} carries, want {pop_cfg.num_agents}")
        out, rows = [], []
        for i, carry in enumerate(carries):
            carry, metrics = iteration(carry, env_params, None if draws is None else draws[i])
            out.append(carry)
            rows.append(metrics)
        return out, {k: torch.stack([m[k] for m in rows]) for k in rows[0]}

    return population_iteration


def population_returns(carries: Sequence[loop_mod.TrainCarry]) -> torch.Tensor:
    """(P,) mean finished-episode return per agent (0 before any episode ends)."""
    return torch.stack([
        c.return_sum.sum() / torch.clamp(c.episodes.sum(), min=1) for c in carries
    ])


def clone_winners(
    carries: Sequence[loop_mod.TrainCarry],
    fraction: float = 0.25,
    pick: Sequence[int] | torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> list[loop_mod.TrainCarry]:
    """The carries with each of the ``n_cut = max(int(P · fraction), 1)``
    lowest-return agents (a stable ascending sort, so ties keep agent order)
    given a copy of the agent state of ``winners[pick[j]]``, the winners
    being the ``n_cut`` highest. ``pick`` (n_cut,) in [0, n_cut) is drawn
    uniformly from ``generator`` (a CPU generator) when not given. Every
    copy is taken from the agents as they were before the call."""
    returns = population_returns(carries)
    n_cut = max(int(len(carries) * fraction), 1)
    order = torch.argsort(returns, stable=True).tolist()
    losers, winners = order[:n_cut], order[-n_cut:]
    if pick is None:
        pick = torch.randint(0, n_cut, (n_cut,), generator=generator)
    pick = [int(j) for j in pick]
    if len(pick) != n_cut or not all(0 <= j < n_cut for j in pick):
        raise ValueError(f"pick {pick} must hold {n_cut} indices in [0, {n_cut})")
    out = list(carries)
    for loser, j in zip(losers, pick):
        out[loser] = dataclasses.replace(carries[loser],
                                         agent=copy.deepcopy(carries[winners[j]].agent))
    return out
