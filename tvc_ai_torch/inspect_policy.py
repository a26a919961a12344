"""Inspect a trained policy's behaviour: trajectory printout and episode stats.

    python -m tvc_ai_torch.inspect_policy --model_path RUN/checkpoints_best \\
        [--hidden 256 256] [--obs_dim 10] [--episodes 3] [--print_every 50] \\
        [--randomize] [--cpu]

The counterpart of ``scripts/inspect_policy.py``, with its flags, defaults
and printed lines: a port checkpoint (or a ``SACAgent.save`` file) flies
deterministic episodes of the default config's env (DR and sensor noise on
with ``--randomize``) one at a time through the single-env core
(``env.single.SingleEnv``: K1 at N = 1 on the card, one host read per step),
printing the altitude / tilt / |ω| / vz / fuel / action / return profile.
Episode ``ep`` starts from a generator seeded ``100 + ep`` (the reference
resets it with key ``100 + ep``). It runs on CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    parser = argparse.ArgumentParser(description="inspect a policy (PyTorch/CUDA port)")
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--hidden", type=int, nargs="*", default=[256, 256])
    parser.add_argument("--obs_dim", type=int, default=10)
    parser.add_argument("--episodes", type=int, default=3)
    parser.add_argument("--print_every", type=int, default=50)
    parser.add_argument("--randomize", action="store_true")
    add_device_flags(parser, device_flag=False)
    args = parser.parse_args(argv)

    from tvc_ai_torch.agents import sac as sac_mod
    from tvc_ai_torch.config import build_env_params, load_config
    from tvc_ai_torch.eval.evaluate import load_agent_state

    dev = resolve_device(device_from_flags(parser, args))
    cfg = load_config(None)
    cfg.env.domain_randomization.enabled = args.randomize
    cfg.env.domain_randomization.sensor_noise_enabled = args.randomize
    env_params = build_env_params(cfg)
    sac_cfg = sac_mod.SACConfig(hidden_dims=tuple(args.hidden))
    agent = load_agent_state(args.model_path, args.obs_dim, 2, sac_cfg, dev)
    inspect(agent.actor, env_params, args.episodes, args.print_every, dev)
    return 0


def inspect(actor, env_params, episodes: int, print_every: int, device, draws=None) -> None:
    """Fly and print ``episodes`` deterministic episodes; ``draws(ep)``, when
    given, returns episode ep's ``(ResetDraws, step_draws)``, ``step_draws(t)``
    giving step t's ``(n_imu, u_drop)``."""
    import numpy as np
    import torch

    from tvc_ai_torch.agents import sac as sac_mod
    from tvc_ai_torch.env.single import SingleEnv

    def extra(state, out):
        return {"alt": out.altitude, "tilt": out.tilt, "w": out.angular_velocity_mag,
                "vz": state.body.vel[:, 2], "fuel": out.fuel, "success": out.mission_success,
                "crashed": out.crashed}

    for ep in range(episodes):
        env = SingleEnv(env_params, device, seed=100 + ep)
        reset_draws, step_draws = draws(ep) if draws is not None else (None, None)
        env.reset(reset_draws)
        total, steps = 0.0, 0
        print(f"\n=== episode {ep} ===")
        print(f"{'step':>5} {'alt':>7} {'tilt°':>7} {'|ω|':>7} {'vz':>7} "
              f"{'fuel':>6} {'act':>14} {'r':>8}")
        while True:
            with torch.no_grad():
                action = sac_mod.select_action(actor, env.obs, deterministic=True)
            n_imu, u_drop = step_draws(steps) if step_draws is not None else (None, None)
            r = env.step(action, n_imu, u_drop,
                         extra=lambda s, o: {**extra(s, o), "act": action[0]})
            x = r.extra
            total += r.reward
            steps += 1
            if steps % print_every == 0 or r.terminated or r.truncated:
                a = x["act"]
                print(
                    f"{steps:5d} {float(x['alt'][0]):7.2f} "
                    f"{np.degrees(float(x['tilt'][0])):7.2f} "
                    f"{float(x['w'][0]):7.3f} "
                    f"{float(x['vz'][0]):7.2f} "
                    f"{float(x['fuel'][0]):6.3f} "
                    f"[{a[0]:+5.2f},{a[1]:+5.2f}] {total:8.1f}"
                )
            if r.terminated or r.truncated:
                reason = "SUCCESS" if bool(x["success"][0]) else (
                    "crash" if bool(x["crashed"][0]) else
                    ("truncated" if r.truncated else "terminated")
                )
                print(f"  -> {reason} after {steps} steps, return {total:.1f}")
                break


if __name__ == "__main__":
    raise SystemExit(main())
