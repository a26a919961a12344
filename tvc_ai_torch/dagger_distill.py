"""Distill the gain-scheduled LQR or the per-draw CEM teacher into a blind student.

    python -m tvc_ai_torch.dagger_distill --out outputs/dagger_r4 [--cpu] ...
    python -m tvc_ai_torch.evaluate --model_path outputs/dagger_r4/student.pt \\
        --drift_obs --action_obs --history 8

The counterpart of ``scripts/dagger_distill.py``, with its flags, defaults
and printed lines (``training.dagger`` has the method). The student trains
on the robustness suite's construction with a widened DR box, and each
iteration evaluates the deterministic student on the official suites
(robustness, stress, and ``robust_cg0`` when training CG-free). The best
iteration's student is written as ``student.pt``: a whole SAC state in
``SACAgent.save``'s form (the actor the student, the critic, targets and
optimizers a fresh template), which ``python -m tvc_ai_torch.evaluate``,
``eval.evaluate.load_agent_state`` and ``training.warm_start_actor`` read;
``--save_every N`` also writes ``student_{iter:03d}.pt``. It runs on CUDA
unless ``--cpu`` is given (and raises where there is no card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np


def f32(x: float) -> float:
    """``x`` rounded to float32, as the reference's ``jnp.float32`` overrides."""
    return float(np.float32(x))


def widened_params(base, mass_variation: float, thrust_variation: float, cg_offset_max: float,
                   wind_max: float):
    """``base`` with its DR box widened (the students' training env)."""
    return dataclasses.replace(base, randomization=dataclasses.replace(
        base.randomization, mass_variation=f32(mass_variation),
        thrust_variation=f32(thrust_variation), cg_offset_max=f32(cg_offset_max),
        wind_max=f32(wind_max)))


def suite_eval_params(obs_overrides: dict, cg_free: bool) -> dict:
    """The official suites the students are evaluated on; with a CG-free
    training run the matching ``robust_cg0`` variant comes first (the
    primary metric)."""
    from tvc_ai_torch.eval.evaluate import _suite_env_params

    out = {"robustness": _suite_env_params("robustness", obs_overrides=obs_overrides),
           "stress": _suite_env_params("stress", obs_overrides=obs_overrides)}
    if cg_free:
        rob = out["robustness"]
        out = {"robust_cg0": dataclasses.replace(rob, randomization=dataclasses.replace(
            rob.randomization, cg_offset_max=0.0)), **out}
    return out


def success_rates(eval_fns: dict, eval_params: dict, agent, seed: int, dev) -> dict:
    """Each suite's strict success rate for ``agent`` (the suites' draws from
    a generator seeded ``seed``)."""
    import torch

    return {name: float(fn(agent, torch.Generator(device=dev).manual_seed(seed),
                           eval_params[name]).success.float().mean())
            for name, fn in eval_fns.items()}


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    p = argparse.ArgumentParser(description="DAgger distillation (PyTorch/CUDA port)")
    p.add_argument("--out", default="outputs/dagger_r4")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--envs", type=int, default=512)
    p.add_argument("--rollout_steps", type=int, default=512)
    p.add_argument("--train_steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lr_cosine", action="store_true",
                   help="cosine-decay the BC learning rate over the whole run (to lr/10)")
    p.add_argument("--history", type=int, default=8)
    p.add_argument("--hidden", type=int, nargs="*", default=[256, 256])
    p.add_argument("--beta0", type=float, default=1.0)
    p.add_argument("--beta_decay", type=float, default=0.6,
                   help="beta_i = beta0 * decay^i (prob. teacher drives)")
    p.add_argument("--beta_floor", type=float, default=0.0,
                   help="keep at least this much teacher-driving forever")
    p.add_argument("--teacher", choices=["scheduled", "cem"], default="cem",
                   help="'scheduled': gain-scheduled LQR (persistent envs, autoreset); "
                        "'cem': per-draw CEM-refined controller (fresh draws + episodic "
                        "rollouts each iteration)")
    p.add_argument("--cem_pop", type=int, default=32)
    p.add_argument("--cem_gens", type=int, default=15)
    p.add_argument("--cem_horizon", type=int, default=500)
    p.add_argument("--cem_anchor", type=float, default=0.0,
                   help="canonicalize per-draw CEM winners toward the schedule init")
    p.add_argument("--cem_obs_noise", type=float, default=0.0,
                   help="refine teachers under IMU noise of this sigma (0.02 = the suite)")
    p.add_argument("--cem_alive", type=float, default=0.0,
                   help="survival term in the CEM score (cem.CEMConfig.alive_weight)")
    p.add_argument("--eval_episodes", type=int, default=128)
    p.add_argument("--save_every", type=int, default=0,
                   help="also save student_{iter:03d}.pt every N iterations")
    p.add_argument("--seed", type=int, default=0)
    add_device_flags(p, device_flag=False)
    p.add_argument("--trim_obs", action="store_true",
                   help="add the 4 trim-observation channels")
    p.add_argument("--trim_mode", choices=["ema", "integral"], default="ema")
    p.add_argument("--mass_variation", type=float, default=0.35)
    p.add_argument("--thrust_variation", type=float, default=0.25)
    p.add_argument("--cg_offset_max", type=float, default=0.06)
    p.add_argument("--wind_max", type=float, default=3.5)
    args = p.parse_args(argv)

    import torch

    from tvc_ai_torch.agents import optim
    from tvc_ai_torch.agents import sac as sac_mod
    from tvc_ai_torch.env.types import obs_dim as obs_dim_of
    from tvc_ai_torch.eval import rollout as rollout_mod
    from tvc_ai_torch.eval.evaluate import _suite_env_params
    from tvc_ai_torch.training import cem as cem_mod
    from tvc_ai_torch.training import dagger, demos

    dev = resolve_device(device_from_flags(p, args))
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    obs_overrides = dict(drift_obs_enabled=True, action_obs_enabled=True)
    if args.trim_obs:
        obs_overrides.update(trim_obs_enabled=True,
                             trim_obs_integral=args.trim_mode == "integral")
    train_params = widened_params(_suite_env_params("robustness", obs_overrides=obs_overrides),
                                  args.mass_variation, args.thrust_variation,
                                  args.cg_offset_max, args.wind_max)
    eval_params = suite_eval_params(obs_overrides, args.cg_offset_max == 0.0)
    obs_dim = obs_dim_of(train_params)
    act_dim = 2
    print(f"obs_dim={obs_dim} history={args.history} view={obs_dim * args.history}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    sched = demos.design_lqr_schedule(train_params, device=dev)
    print(f"teacher schedule designed in {time.time() - t0:.0f}s")
    sched_d = sched.to(dev)
    rp = train_params.rocket

    def teacher_fn(env_states):
        return demos.lqr_action_scheduled(env_states.body, sched_d, env_states.dr.mass,
                                          env_states.dr.thrust_scale,
                                          torch.zeros_like(env_states.dr.cg_offset), rp)

    sac_cfg = sac_mod.SACConfig(hidden_dims=tuple(args.hidden))
    dcfg = dagger.DaggerConfig(num_envs=args.envs, rollout_steps=args.rollout_steps,
                               capacity=(args.envs * args.rollout_steps) * 8,
                               batch_size=args.batch, train_steps=args.train_steps, lr=args.lr,
                               history_len=args.history)
    view_dim = obs_dim * args.history
    template = sac_mod.init(view_dim, act_dim, sac_cfg, dev, seed=args.seed)
    lr_fn = (optim.cosine_decay(dcfg.lr, args.iters * dcfg.train_steps, alpha=0.1)
             if args.lr_cosine else None)
    if args.teacher == "cem":
        cem_cfg = cem_mod.CEMConfig(pop=args.cem_pop, generations=args.cem_gens,
                                    horizon=args.cem_horizon, anchor_weight=args.cem_anchor,
                                    obs_noise_std=args.cem_obs_noise,
                                    alive_weight=args.cem_alive)
        state = dagger.init_cem_state(template.actor, dcfg, obs_dim, act_dim, dev)
        iteration = dagger.make_cem_dagger_iteration(train_params, sched, sac_cfg, dcfg, obs_dim,
                                                     act_dim, cem_cfg, lr_fn=lr_fn)
    else:
        state = dagger.init_state(train_params, template.actor, dcfg, obs_dim, act_dim, dev, gen)
        iteration = dagger.make_dagger_iteration(train_params, teacher_fn, sac_cfg, dcfg,
                                                 obs_dim, act_dim, lr_fn=lr_fn)

    # evaluation: the deterministic student on the official suite params
    @torch.no_grad()
    def policy_fn(actor, obs):
        return torch.tanh(actor(obs)[0])

    eval_fns = {name: rollout_mod.make_policy_eval_fn(policy_fn, args.eval_episodes,
                                                      history_len=args.history)
                for name in eval_params}
    primary = next(iter(eval_params))   # robust_cg0 when training CG-free
    best = {primary: -1.0}
    history = []
    for i in range(args.iters):
        beta = max(args.beta_floor, args.beta0 * (args.beta_decay ** i))
        t0 = time.time()
        state, metrics = iteration(state, beta, generator=gen)
        metrics = {k: float(v) for k, v in metrics.items()}
        eval_seed = int(torch.randint(2**62, (), device=dev, generator=gen))
        scores = success_rates(eval_fns, eval_params, state.actor, eval_seed, dev)
        dt = time.time() - t0
        roll_sr = metrics["rollout_success"] / max(metrics["rollout_episodes"], 1)
        teach = (f"teacher_solved={metrics['teacher_solved']:.2%} "
                 if "teacher_solved" in metrics else "")
        suite_str = " ".join(f"{n}={scores[n]:.2%}" for n in scores)
        print(f"iter {i:3d} beta={beta:.3f} "
              f"bc {metrics['bc_loss_first']:.5f}->{metrics['bc_loss_last']:.5f} "
              f"{teach}rollout_sr={roll_sr:.2%} {suite_str} ({dt:.0f}s)", flush=True)
        history.append({"iter": i, "beta": beta, **metrics, **scores})
        if scores[primary] > best[primary]:
            best = {"iter": i, **scores}
            dagger.save_student(out / "student.pt", state.actor, sac_cfg, view_dim, act_dim,
                                args.seed)
        if args.save_every and (i + 1) % args.save_every == 0:
            dagger.save_student(out / f"student_{i:03d}.pt", state.actor, sac_cfg, view_dim,
                                act_dim, args.seed)
    (out / "history.json").write_text(json.dumps(
        {"best": best, "history": history, "args": vars(args)}, indent=2))
    print(f"best: {best}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
