"""Per-axis domain-randomization ablation of a trained policy.

    python -m tvc_ai_torch.ablate_dr --model_path RUN/checkpoints_best [--episodes 64] \\
        [--hidden 256 256] [--history 1] [--seed 0] [--cpu]

The counterpart of ``scripts/ablate_dr.py``, with its flags, defaults and
printed lines: a port checkpoint (or a ``SACAgent.save`` file) is evaluated
with ``eval.rollout.make_eval_fn`` (K1 on the card) with each DR axis on in
isolation (mass ±30 %, thrust ±20 %, CG 0.05 m, wind 3 N, sensor noise 0.02),
with none and with all together, so the axis that costs success shows.
Every axis starts from a generator seeded ``--seed``. It runs on CUDA unless
``--cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    parser = argparse.ArgumentParser(description="per-axis DR ablation (PyTorch/CUDA port)")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--episodes", type=int, default=64)
    parser.add_argument("--hidden", type=int, nargs="*", default=[256, 256])
    parser.add_argument("--history", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0)
    add_device_flags(parser, device_flag=False)
    args = parser.parse_args(argv)

    from tvc_ai_torch.agents import sac as sac_mod
    from tvc_ai_torch.eval.evaluate import load_agent_state

    dev = resolve_device(device_from_flags(parser, args))
    sac_cfg = sac_mod.SACConfig(hidden_dims=tuple(args.hidden))
    state = load_agent_state(args.model_path, 10 * args.history, 2, sac_cfg, dev)
    ablate(state, sac_cfg, args.episodes, args.history, args.seed)
    return 0


def axes(horizon: int = 1000) -> dict:
    """Each ablation's env parameters, in the reference's order."""
    import dataclasses

    from tvc_ai_torch.env.single import RocketConfig
    from tvc_ai_torch.env.types import RandomizationConfig, as_float32

    base = RocketConfig(mass=2.0).to_env_params(
        domain_randomization=False, sensor_noise=False, max_episode_steps=horizon
    )

    def rc(**kw):
        defaults = dict(enabled=True, mass_variation=0.0, thrust_variation=0.0,
                        cg_offset_max=0.0, wind_max=0.0)
        defaults.update(kw)
        return dataclasses.replace(base, randomization=as_float32(RandomizationConfig(**defaults)))

    return {
        "none (nominal)": rc(),
        "mass +-30%": rc(mass_variation=0.3),
        "thrust +-20%": rc(thrust_variation=0.2),
        "cg 0.05 m": rc(cg_offset_max=0.05),
        "wind 3 N": rc(wind_max=3.0),
        "noise fixed 0.02": rc(sensor_noise_enabled=True),
        "ALL (robustness suite)": rc(mass_variation=0.3, thrust_variation=0.2,
                                     cg_offset_max=0.05, wind_max=3.0,
                                     sensor_noise_enabled=True),
    }


def ablate(state, sac_cfg, episodes: int, history: int, seed: int, horizon: int = 1000,
           draws: dict | None = None) -> dict:
    """Evaluate ``state`` on every axis and print the reference's line for
    each; ``draws`` maps an axis name to its ``EvalDraws`` (else a generator
    seeded ``seed`` on the agent's device). Returns the metrics by axis."""
    import torch

    from tvc_ai_torch.eval.rollout import make_eval_fn, summarize_stats

    dev = state.log_alpha.device
    fn = make_eval_fn(sac_cfg, episodes, history_len=history)
    results = {}
    for name, params in axes(horizon).items():
        d = (draws or {}).get(name)
        gen = None if d is not None else torch.Generator(device=dev).manual_seed(seed)
        m = results[name] = summarize_stats(fn(state, gen, params, d))
        print(
            f"{name:24s} success {m['eval_success_rate']:7.2%} "
            f"legacy {m['eval_legacy_success_rate']:7.2%} "
            f"crash {m['eval_crash_rate']:6.2%} "
            f"len {m['eval_length_mean']:5.0f} "
            f"reward {m['eval_reward_mean']:8.0f}"
        )
    return results


if __name__ == "__main__":
    raise SystemExit(main())
