"""SAC hyperparameter search.

    python -m tvc_ai_torch.tune_hyperparameters [--n_trials 20] [--trial_steps 50000] \\
        [--num_envs 256] [--output_dir hpo_output] [--seed 0] [--cpu]

The counterpart of ``scripts/tune_hyperparameters.py``, with its flags,
defaults and printed lines: Optuna when installed, otherwise the built-in
random search with median pruning (``tuning.hpo``); it writes
``trials.json``, ``best_params.json`` and ``trials.csv`` to ``--output_dir``.
Each trial trains and evaluates on CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags

    parser = argparse.ArgumentParser(description="TVC HPO (PyTorch/CUDA port)")
    parser.add_argument("--n_trials", type=int, default=20)
    parser.add_argument("--trial_steps", type=int, default=50_000)
    parser.add_argument("--num_envs", type=int, default=256)
    parser.add_argument("--output_dir", type=str, default="hpo_output")
    parser.add_argument("--seed", type=int, default=0)
    add_device_flags(parser, device_flag=False)
    args = parser.parse_args(argv)

    from tvc_ai_torch.tuning.hpo import HAS_OPTUNA, make_sac_objective, run_study

    objective = make_sac_objective(
        total_steps=args.trial_steps, num_envs=args.num_envs, seed=args.seed,
        device=device_from_flags(parser, args),
    )
    print(f"backend: {'optuna' if HAS_OPTUNA else 'built-in random search'}")
    best, results = run_study(
        objective, n_trials=args.n_trials, seed=args.seed,
        output_dir=args.output_dir,
    )
    pruned = sum(r.pruned for r in results)
    print(f"{len(results)} trials ({pruned} pruned)")
    print(f"best eval reward: {best.value:.1f}")
    for k, v in best.params.items():
        print(f"  {k} = {v}")
    print(f"artifacts: {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
