"""Export a trained actor to int8 TFLite-Micro artifacts.

    python -m tvc_ai_torch.export --model_path RUN/checkpoints_best --obs_dim 10 \\
        [--output_dir export_output] [--optimization none|default|aggressive] \\
        [--hidden 256 256] [--generate_c_array] [--cpu]

The counterpart of ``scripts/export_tflm.py``, with its flags and printed
lines. ``--model_path`` is a ``SACAgent.save`` file or a port checkpoint
directory (a manager root or one step directory, whose EMA actor is
preferred when it has one). The calibration rollout runs on CUDA unless
``--cpu`` is given. The TFLite route needs TensorFlow; without it the
command fails with ``ExportError``. The native ``.tvcq`` route is the API
of ``tvc_ai_torch.export.micro``.
"""

from __future__ import annotations

import argparse

from tvc_ai_torch.utils.devices import (
    DEFAULT_DEVICE,
    add_device_flags,
    device_from_flags,
    resolve_device,
)


def load_actor_params(model_path: str, obs_dim: int, action_dim: int, hidden,
                      device=DEFAULT_DEVICE):
    """The actor of a ``SACAgent.save`` file or a port checkpoint directory."""
    from tvc_ai_torch.agents.sac import SACConfig
    from tvc_ai_torch.eval.evaluate import load_agent_state

    cfg = SACConfig(hidden_dims=tuple(hidden))
    return load_agent_state(model_path, obs_dim, action_dim, cfg, device).actor


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tvc_ai_torch.export",
                                     description="TFLM int8 export")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="export_output")
    parser.add_argument(
        "--optimization", choices=["none", "default", "aggressive"], default="default",
    )
    parser.add_argument("--obs_dim", type=int, default=8)
    parser.add_argument("--action_dim", type=int, default=2)
    parser.add_argument("--hidden", type=int, nargs="*", default=[256, 256])
    parser.add_argument("--validate", action="store_true")
    parser.add_argument("--benchmark", action="store_true")
    parser.add_argument("--generate_c_array", action="store_true")
    add_device_flags(parser, device_flag=False)
    args = parser.parse_args(argv)

    from tvc_ai_torch.env.single import RocketConfig
    from tvc_ai_torch.export.c_array import generate_c_array, generate_tflm_example
    from tvc_ai_torch.export.tflite import export_actor

    dev = resolve_device(device_from_flags(parser, args))
    actor = load_actor_params(args.model_path, args.obs_dim, args.action_dim, args.hidden, dev)
    env_params = RocketConfig().to_env_params(
        domain_randomization=False, sensor_noise=False, max_episode_steps=1000
    )
    result = export_actor(
        actor,
        obs_dim=args.obs_dim,
        env_params=env_params,
        output_dir=args.output_dir,
        optimization=args.optimization,
        device=dev,
    )
    print(f"tflite: {result.tflite_path} ({result.size_bytes} bytes)")
    print(
        f"int8 parity: max |Δa| = {result.max_action_diff:.4f} "
        f"(threshold 0.1), mean = {result.mean_action_diff:.4f}"
    )
    print(f"host latency: {result.latency_us:.1f} µs/inference")
    if result.max_action_diff > 0.1:
        print("WARNING: parity above the 0.1 export threshold")

    if args.generate_c_array:
        cc, h = generate_c_array(result.tflite_path.read_bytes(), args.output_dir)
        example = generate_tflm_example(
            args.output_dir, obs_dim=args.obs_dim, action_dim=args.action_dim
        )
        print(f"C artifacts: {cc}, {h}, {example}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
