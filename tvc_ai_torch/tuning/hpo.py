"""Hyperparameter optimization harness.

Counterpart of ``tvc_ai_tpu/tuning/hpo.py``: the same study over the
reference's SAC search space (lr_actor / lr_critic / lr_alpha log-uniform
1e-5..1e-2, γ 0.9..0.999, τ 5e-4..2e-2 log-uniform, batch {128, 256, 512},
hidden {128, 256, 512}), maximizing the eval reward with median pruning.
Optuna runs it when importable; otherwise a built-in random search with
median pruning and the same trial API does (Optuna is absent here).

Each trial trains with the port's fused iteration (``training.loop``: K1 on
the card) and scores with the batched evaluation (``eval.rollout``), on
CUDA unless the objective is built with ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import random
from pathlib import Path
from typing import Any, Callable

import torch

from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device

HAS_OPTUNA = importlib.util.find_spec("optuna") is not None
ROLLOUT_STEPS = 64


@dataclasses.dataclass
class TrialResult:
    number: int
    params: dict[str, Any]
    value: float
    pruned: bool = False
    intermediate: list[float] = dataclasses.field(default_factory=list)


class Pruned(Exception):
    pass


class _FallbackTrial:
    """Optuna-compatible trial facade for the built-in random search."""

    def __init__(self, number: int, rng: random.Random, medians: list[list[float]]):
        self.number = number
        self._rng = rng
        self._medians = medians
        self.params: dict[str, Any] = {}
        self.intermediate: list[float] = []

    def suggest_float(self, name, low, high, log=False):
        if log:
            value = math.exp(self._rng.uniform(math.log(low), math.log(high)))
        else:
            value = self._rng.uniform(low, high)
        self.params[name] = value
        return value

    def suggest_categorical(self, name, choices):
        value = self._rng.choice(list(choices))
        self.params[name] = value
        return value

    def report(self, value: float, step: int) -> None:
        self.intermediate.append(value)

    def should_prune(self) -> bool:
        """Median pruning: below the median of other trials at this rung."""
        rung = len(self.intermediate) - 1
        peers = [t[rung] for t in self._medians if len(t) > rung]
        if len(peers) < 3:
            return False
        peers_sorted = sorted(peers)
        median = peers_sorted[len(peers_sorted) // 2]
        return self.intermediate[-1] < median


def default_search_space(trial) -> dict[str, Any]:
    """The reference's SAC search space."""
    return {
        "lr_actor": trial.suggest_float("lr_actor", 1e-5, 1e-2, log=True),
        "lr_critic": trial.suggest_float("lr_critic", 1e-5, 1e-2, log=True),
        "lr_alpha": trial.suggest_float("lr_alpha", 1e-5, 1e-2, log=True),
        "gamma": trial.suggest_float("gamma", 0.9, 0.999),
        "tau": trial.suggest_float("tau", 5e-4, 2e-2, log=True),
        "batch_size": trial.suggest_categorical("batch_size", [128, 256, 512]),
        "hidden_dim": trial.suggest_categorical("hidden_dim", [128, 256, 512]),
    }


def make_sac_objective(
    total_steps: int = 50_000,
    num_envs: int = 256,
    eval_every_fraction: float = 0.2,
    eval_episodes: int = 8,
    seed: int = 0,
    device: str | torch.device = DEFAULT_DEVICE,
):
    """Objective: a short fused SAC run, the eval reward as the score,
    prunable. Trial k's networks and env stream come from ``seed + k``; the
    eval after iteration i draws from a generator seeded ``1000 + i``. It
    trains ``max(total_steps // (num_envs · 64), 1)`` iterations of 64 steps
    and evaluates every ``max(int(iterations · eval_every_fraction), 1)``
    iterations and after the last, reporting each score at its iteration."""
    from tvc_ai_torch.agents.sac import SACConfig
    from tvc_ai_torch.env.types import EnvParams
    from tvc_ai_torch.eval.rollout import make_eval_fn, summarize_stats
    from tvc_ai_torch.training import loop as loop_mod

    dev = resolve_device(device)

    def objective(trial) -> float:
        params = default_search_space(trial)
        h = int(params["hidden_dim"])
        sac_cfg = SACConfig(
            hidden_dims=(h, h),
            lr_actor=params["lr_actor"],
            lr_critic=params["lr_critic"],
            lr_alpha=params["lr_alpha"],
            gamma=params["gamma"],
            tau=params["tau"],
            batch_size=int(params["batch_size"]),
            buffer_size=200_000,
            learning_starts=1000,
        )
        env_params = EnvParams()
        loop_cfg = loop_mod.TrainLoopConfig(num_envs=num_envs, rollout_steps=ROLLOUT_STEPS)
        carry = loop_mod.init_carry(env_params, sac_cfg, loop_cfg, device=dev,
                                    seed=seed + trial.number)
        it = loop_mod.make_train_iteration(sac_cfg, loop_cfg)
        eval_fn = make_eval_fn(sac_cfg, eval_episodes)
        total_iters = max(total_steps // (num_envs * ROLLOUT_STEPS), 1)
        eval_every = max(int(total_iters * eval_every_fraction), 1)
        score = -float("inf")
        for i in range(total_iters):
            carry, _ = it(carry, env_params)
            if (i + 1) % eval_every == 0 or i == total_iters - 1:
                gen = torch.Generator(device=dev).manual_seed(1000 + i)
                score = summarize_stats(eval_fn(carry.agent, gen, env_params))[
                    "eval_reward_mean"]
                trial.report(score, i)
                if trial.should_prune():
                    raise Pruned()
        return score

    return objective


def run_study(
    objective: Callable,
    n_trials: int = 20,
    seed: int = 0,
    output_dir: str | Path | None = None,
) -> tuple[TrialResult, list[TrialResult]]:
    """Run with Optuna if present, else the built-in random search."""
    results: list[TrialResult] = []
    if HAS_OPTUNA:  # pragma: no cover - optuna absent here
        import optuna

        study = optuna.create_study(
            direction="maximize",
            pruner=optuna.pruners.MedianPruner(),
            sampler=optuna.samplers.TPESampler(seed=seed),
        )

        def wrapped(trial):
            try:
                return objective(trial)
            except Pruned:
                raise optuna.TrialPruned()

        study.optimize(wrapped, n_trials=n_trials)
        for t in study.trials:
            results.append(
                TrialResult(
                    t.number,
                    t.params,
                    t.value if t.value is not None else -float("inf"),
                    pruned=t.state.name == "PRUNED",
                )
            )
    else:
        rng = random.Random(seed)
        histories: list[list[float]] = []
        for number in range(n_trials):
            trial = _FallbackTrial(number, rng, histories)
            try:
                value = objective(trial)
                pruned = False
            except Pruned:
                value = trial.intermediate[-1] if trial.intermediate else -float("inf")
                pruned = True
            histories.append(trial.intermediate)
            results.append(
                TrialResult(
                    number, trial.params, value, pruned, trial.intermediate
                )
            )

    best = max(
        (r for r in results if not r.pruned),
        key=lambda r: r.value,
        default=max(results, key=lambda r: r.value),
    )
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        (output_dir / "trials.json").write_text(
            json.dumps([dataclasses.asdict(r) for r in results], indent=2)
        )
        (output_dir / "best_params.json").write_text(
            json.dumps({"value": best.value, "params": best.params}, indent=2)
        )
        _write_trials_csv(results, output_dir / "trials.csv")
    return best, results


def _write_trials_csv(results: list[TrialResult], path: Path) -> None:
    import csv

    keys = sorted({k for r in results for k in r.params})
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["number", "value", "pruned"] + keys)
        for r in results:
            writer.writerow(
                [r.number, r.value, r.pruned] + [r.params.get(k) for k in keys]
            )
