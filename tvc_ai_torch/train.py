"""Train a TVC policy with the PyTorch port — its main entry point.

    python -m tvc_ai_torch.train --config tvc_ai_torch/config/default.yaml \\
        [--device cuda|cpu | --cpu] [--resume DIR] [--output-dir DIR] [--debug] \\
        training.total_timesteps=500000 training.num_envs=2048

The counterpart of ``scripts/train.py``: ``--config`` (default: the package's
``config/default.yaml``), dotted overrides, ``--debug`` for a small fast run,
and ``--resume`` from a checkpoint directory (a manager root or one step
directory; for the ensemble routes, an ``ensemble_final.pt`` file). It runs
on CUDA unless ``--device cpu`` (or the reference's ``--cpu``) is given. ``training.algorithm`` picks the
trainer as the reference does: ``ensemble`` runs ``EnsembleTrainer``,
``ppo`` and ``td3`` run it with that member forced to act, anything else
runs the fused SAC ``Trainer``.

Data-parallel training is launched with ``torchrun``, one process per
device:

    torchrun --standalone --nproc-per-node N -m tvc_ai_torch.train --config ...

Each rank trains on ``cuda:LOCAL_RANK`` over NCCL, or with ``--device cpu``
on the CPU over gloo; ``hardware.mesh_devices`` is 0 (the launched world) or
N. Rank 0 logs, writes the run directory's files and prints the result.
"""

from __future__ import annotations

import argparse
import functools

import torch

from tvc_ai_torch.parallel import mesh
from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="TVC trainer (PyTorch/CUDA port)")
    parser.add_argument("--config", type=str, default=None,
                        help="YAML config path (default: the package's default.yaml)")
    parser.add_argument("--debug", action="store_true", help="small fast run")
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint to resume from: a manager root (its latest step) or "
                             "one step directory, of this package (at the world that wrote it) "
                             "or of the JAX package's orbax (at any world its env batch divides "
                             "over); merged into the fresh carry as the reference merges. The "
                             "ensemble routes take an ensemble_final.pt or .msgpack file")
    parser.add_argument("--output-dir", type=str, default=None)
    add_device_flags(parser)
    parser.add_argument("overrides", nargs="*", help="dotted config overrides: a.b.c=value")
    args = parser.parse_args(argv)
    device = device_from_flags(parser, args)

    from tvc_ai_torch.config import default_config_path, load_config, save_config

    cfg = load_config(args.config or default_config_path(), overrides=args.overrides)
    algo = cfg.training.algorithm
    if algo in ("ensemble", "ppo", "td3"):
        from tvc_ai_torch.training.trainer_ensemble import EnsembleTrainer

        Trainer = functools.partial(EnsembleTrainer,
                                    forced_actor=None if algo == "ensemble" else algo)
    else:  # sac (default): the dedicated fused SAC trainer
        from tvc_ai_torch.training.trainer import Trainer

    if args.debug:
        cfg.globals.debug = True
        cfg.training.total_timesteps = min(cfg.training.total_timesteps, 50_000)
        cfg.training.num_envs = min(cfg.training.num_envs, 64)
        cfg.training.rollout_steps = min(cfg.training.rollout_steps, 32)
        cfg.logging.level = "DEBUG"

    trainer = Trainer(cfg, output_dir=args.output_dir, resume=args.resume, device=device)
    if mesh.rank() == 0:
        save_config(cfg, trainer.output_dir / "config.yaml")
    result = trainer.train()
    if mesh.rank() == 0:
        print(
            f"final: success={result['eval_success_rate']:.2%} "
            f"reward={result['eval_reward_mean']:.1f} "
            f"steps/s={result['steps_per_sec']:,.0f}"
        )
    if mesh.active():
        mesh.barrier()
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
