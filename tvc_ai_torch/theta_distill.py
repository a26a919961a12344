"""Distill the per-draw CEM teacher into a blind θ-student.

    python -m tvc_ai_torch.theta_distill --out outputs/theta_r4 [--cpu] ...

The counterpart of ``scripts/theta_distill.py``, with its flags, defaults
and printed lines (``training.theta_student`` has the method): the student
regresses each episode's constant controller (10 components) from the
stacked (obs, action) history and acts through the known linear form. The
best iteration's net is written as ``theta_student.pt``: ``{"kind",
"hidden_dims", "history_len", "obs_dim", "params" (the ``ThetaNet`` state
dict), "scale" (the regression scales), "config" (the
``ThetaDaggerConfig``)}``. It runs on CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    p = argparse.ArgumentParser(description="θ-student distillation (PyTorch/CUDA port)")
    p.add_argument("--out", default="outputs/theta_r4")
    p.add_argument("--iters", type=int, default=60)
    p.add_argument("--envs", type=int, default=512)
    p.add_argument("--rollout_steps", type=int, default=512)
    p.add_argument("--train_steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lr_cosine", action="store_true")
    p.add_argument("--history", type=int, default=8)
    p.add_argument("--hidden", type=int, nargs="*", default=[256, 256])
    p.add_argument("--beta0", type=float, default=1.0)
    p.add_argument("--beta_decay", type=float, default=0.85)
    p.add_argument("--beta_floor", type=float, default=0.1)
    p.add_argument("--cem_pop", type=int, default=64)
    p.add_argument("--cem_gens", type=int, default=25)
    p.add_argument("--cem_horizon", type=int, default=700)
    p.add_argument("--cem_anchor", type=float, default=0.0)
    p.add_argument("--cem_obs_noise", type=float, default=0.0,
                   help="refine teachers under IMU noise (0.02 = the suite condition)")
    p.add_argument("--cem_alive", type=float, default=0.0,
                   help="survival term in the CEM score (alive_weight)")
    p.add_argument("--eval_episodes", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    add_device_flags(p, device_flag=False)
    p.add_argument("--mass_variation", type=float, default=0.30)
    p.add_argument("--thrust_variation", type=float, default=0.20)
    p.add_argument("--cg_offset_max", type=float, default=0.05)
    p.add_argument("--wind_max", type=float, default=3.0)
    args = p.parse_args(argv)

    import torch

    from tvc_ai_torch.agents import optim
    from tvc_ai_torch.dagger_distill import (
        success_rates,
        suite_eval_params,
        widened_params,
    )
    from tvc_ai_torch.env.types import obs_dim as obs_dim_of
    from tvc_ai_torch.eval import rollout as rollout_mod
    from tvc_ai_torch.eval.evaluate import _suite_env_params
    from tvc_ai_torch.training import cem as cem_mod
    from tvc_ai_torch.training import demos, theta_student

    dev = resolve_device(device_from_flags(p, args))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    obs_overrides = dict(drift_obs_enabled=True, action_obs_enabled=True)
    train_params = widened_params(_suite_env_params("robustness", obs_overrides=obs_overrides),
                                  args.mass_variation, args.thrust_variation,
                                  args.cg_offset_max, args.wind_max)
    eval_params = suite_eval_params(obs_overrides, args.cg_offset_max == 0.0)
    obs_dim = obs_dim_of(train_params)
    print(f"obs_dim={obs_dim} history={args.history} view={obs_dim * args.history}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    sched = demos.design_lqr_schedule(train_params, device=dev)
    print(f"teacher schedule designed in {time.time() - t0:.0f}s")

    tcfg = theta_student.ThetaDaggerConfig(
        num_envs=args.envs, rollout_steps=args.rollout_steps,
        capacity=(args.envs * args.rollout_steps) * 8, batch_size=args.batch,
        train_steps=args.train_steps, lr=args.lr, history_len=args.history,
        hidden_dims=tuple(args.hidden))
    cem_cfg = cem_mod.CEMConfig(pop=args.cem_pop, generations=args.cem_gens,
                                horizon=args.cem_horizon, anchor_weight=args.cem_anchor,
                                obs_noise_std=args.cem_obs_noise, alive_weight=args.cem_alive)
    lr_fn = (optim.cosine_decay(tcfg.lr, args.iters * tcfg.train_steps, alpha=0.1)
             if args.lr_cosine else None)
    state = theta_student.init_theta_state(tcfg, obs_dim, dev, seed=args.seed)
    iteration = theta_student.make_theta_dagger_iteration(train_params, sched, tcfg, obs_dim,
                                                          cem_cfg, lr_fn=lr_fn)
    eval_fns = {name: rollout_mod.make_policy_eval_fn(
        theta_student.make_theta_policy_fn(eval_params[name], tcfg), args.eval_episodes,
        history_len=args.history) for name in eval_params}

    primary = next(iter(eval_params))
    best = {primary: -1.0}
    history = []
    for i in range(args.iters):
        beta = max(args.beta_floor, args.beta0 * (args.beta_decay ** i))
        t0 = time.time()
        state, metrics = iteration(state, beta, generator=gen)
        metrics = {k: float(v) for k, v in metrics.items()}
        eval_seed = int(torch.randint(2**62, (), device=dev, generator=gen))
        scores = success_rates(eval_fns, eval_params, state.net, eval_seed, dev)
        dt = time.time() - t0
        roll_sr = metrics["rollout_success"] / max(metrics["rollout_episodes"], 1)
        suite_str = " ".join(f"{n}={scores[n]:.2%}" for n in scores)
        print(f"iter {i:3d} beta={beta:.3f} "
              f"theta {metrics['theta_loss_first']:.4f}->{metrics['theta_loss_last']:.4f} "
              f"teacher_solved={metrics['teacher_solved']:.2%} "
              f"rollout_sr={roll_sr:.2%} {suite_str} ({dt:.0f}s)", flush=True)
        history.append({"iter": i, "beta": beta, **metrics, **scores})
        if scores[primary] > best[primary]:
            best = {"iter": i, **scores}
            save_theta_student(out / "theta_student.pt", state.net, sched, tcfg, obs_dim)
    (out / "history.json").write_text(json.dumps(
        {"best": best, "history": history, "args": vars(args)}, indent=2))
    print(f"best: {best}")
    return 0


def save_theta_student(path: Path, net, sched, cfg, obs_dim: int) -> None:
    """Write the θ-student artifact (the net, its scales and config)."""
    import torch

    from tvc_ai_torch.training import theta_student

    tmp = path.with_suffix(path.suffix + ".tmp")
    torch.save({"kind": "theta_student", "hidden_dims": list(cfg.hidden_dims),
                "history_len": cfg.history_len, "obs_dim": obs_dim,
                "params": {k: v.cpu() for k, v in net.state_dict().items()},
                "scale": theta_student.theta_scale(sched),
                "config": dataclasses.asdict(cfg)}, tmp)
    tmp.replace(path)


if __name__ == "__main__":
    raise SystemExit(main())
