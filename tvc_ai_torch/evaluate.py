"""Evaluate a trained agent over the Standard / Robustness / Stress suites.

    python -m tvc_ai_torch.evaluate --model_path RUN/checkpoints_best \\
        [--suite standard|robustness|stress|all] [--device cuda|cpu | --cpu] ...

The counterpart of ``scripts/evaluate.py``: ``--model_path`` is a checkpoint
of the port or an orbax checkpoint of the JAX package (a manager root or one
step directory), an agent file of the port (``.pt``) or a flax msgpack agent
file of the JAX package (its ``SACAgent.save`` file or a DAgger
``student.msgpack``). Each suite runs all its episodes as one batch. It runs on CUDA unless ``--device cpu`` (or ``--cpu``) is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="TVC evaluation (PyTorch/CUDA port)")
    parser.add_argument("--model_path", type=str, required=True,
                        help="checkpoint directory (manager root or one step), or an "
                             "agent file (.pt, or the JAX package's .msgpack)")
    parser.add_argument("--output_dir", type=str, default="evaluation_output")
    parser.add_argument("--obs_dim", type=int, default=10)
    parser.add_argument("--action_dim", type=int, default=2)
    parser.add_argument("--hidden", type=int, nargs="*", default=[256, 256])
    parser.add_argument("--episodes_scale", type=float, default=1.0,
                        help="scale the per-suite episode counts")
    parser.add_argument("--suite", choices=["standard", "robustness", "stress", "all"],
                        default="all")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--history", type=int, default=1,
                        help="history_len the agent was trained with (network.history_len)")
    parser.add_argument("--trajectories", type=int, default=0,
                        help="record N standard-suite episode trajectories and plot them")
    parser.add_argument("--rocket_mass", type=float, default=2.0,
                        help="suite nominal mass (1.5 = legacy-generation policies)")
    parser.add_argument("--run_config", type=str, default=None,
                        help="the training run's saved config.yaml: derives the "
                             "observation construction and history exactly as trained; "
                             "overrides the individual flags below")
    parser.add_argument("--trim_obs", action="store_true",
                        help="the 4 trim-observation channels (env.trim_observation)")
    parser.add_argument("--trim_mode", choices=["ema", "integral"], default="ema")
    parser.add_argument("--drift_obs", action="store_true",
                        help="the 4 drift-observation channels (env.drift_observation)")
    parser.add_argument("--action_obs", action="store_true",
                        help="the 2 previous-action channels (env.action_observation)")
    parser.add_argument("--cg_offset_max", type=float, default=None,
                        help="override the suites' CG-offset range (ablation)")
    parser.add_argument("--no_sensor_noise", action="store_true",
                        help="disable the suites' sensor noise (ablation)")
    add_device_flags(parser)
    args = parser.parse_args(argv)

    from tvc_ai_torch.agents.sac import SACConfig
    from tvc_ai_torch.eval.evaluate import (
        SUITE_EPISODES,
        _suite_env_params,
        load_agent_state,
        obs_overrides_from_config,
        run_all_suites,
        run_suite,
        write_episode_csv,
    )
    from tvc_ai_torch.utils.devices import resolve_device

    dev = resolve_device(device_from_flags(parser, args))
    sac_cfg = SACConfig(hidden_dims=tuple(args.hidden))
    if args.run_config:
        from tvc_ai_torch.config import build_env_params, build_sac_config, load_config
        from tvc_ai_torch.env.types import obs_dim as env_obs_dim

        run_cfg = load_config(args.run_config)
        sac_cfg = build_sac_config(run_cfg)
        obs_overrides = obs_overrides_from_config(run_cfg)
        frame_dim = env_obs_dim(build_env_params(run_cfg))
        args.history = run_cfg.network.history_len
    else:
        obs_overrides = {}
        if args.trim_obs:
            obs_overrides.update(trim_obs_enabled=True,
                                 trim_obs_integral=args.trim_mode == "integral")
        if args.drift_obs:
            obs_overrides["drift_obs_enabled"] = True
        if args.action_obs:
            obs_overrides["action_obs_enabled"] = True
        frame_dim = (args.obs_dim + (4 if args.trim_obs else 0)
                     + (4 if args.drift_obs else 0) + (2 if args.action_obs else 0))
    agent_state = load_agent_state(args.model_path, frame_dim * args.history,
                                   args.action_dim, sac_cfg, dev)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    obs_dim = args.obs_dim if args.obs_dim != 10 else None
    sensor_noise = False if args.no_sensor_noise else None
    if args.suite == "all":
        results = run_all_suites(
            agent_state, sac_cfg, out, args.episodes_scale, args.seed, obs_dim,
            args.rocket_mass, args.history, obs_overrides, args.cg_offset_max,
            sensor_noise, dev,
        )
    else:
        episodes = max(int(SUITE_EPISODES[args.suite] * args.episodes_scale), 2)
        result = run_suite(
            agent_state, sac_cfg, args.suite, episodes, args.seed, obs_dim,
            args.rocket_mass, args.history, obs_overrides, args.cg_offset_max,
            sensor_noise, dev,
        )
        write_episode_csv(result, out / f"{args.suite}_episodes.csv")
        results = {args.suite: result}

    if args.trajectories > 0:
        import torch

        from tvc_ai_torch.eval.rollout import make_trajectory_fn, plot_trajectories

        traj_fn = make_trajectory_fn(sac_cfg, args.trajectories, args.action_dim, obs_dim,
                                     history_len=args.history)
        series = traj_fn(agent_state, torch.Generator(device=dev).manual_seed(args.seed),
                         _suite_env_params("standard", args.rocket_mass, obs_overrides))
        plot_trajectories(series, out / "trajectory_plots.png",
                          max_episodes=args.trajectories)
        print(f"trajectories: {out / 'trajectory_plots.png'}")

    for name, result in results.items():
        m = result.metrics
        print(
            f"{name:>10}: success {m['eval_success_rate']:.2%} "
            f"(legacy criterion {m['eval_legacy_success_rate']:.2%}) "
            f"reward {m['eval_reward_mean']:.1f}±{m['eval_reward_std']:.1f} "
            f"crash {m['eval_crash_rate']:.2%} "
            f"p50 {m['eval_reward_p50']:.1f} p95 {m['eval_reward_p95']:.1f}"
        )
    print(f"artifacts: {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
