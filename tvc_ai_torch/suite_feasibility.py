"""Empirical feasibility oracle for the evaluation suites.

    python -m tvc_ai_torch.suite_feasibility [--cpu] [--episodes 200] [--seed 0]
        [--suite robustness stress] [--scheduled | --cem [--reroll N] [--student_view]]

The counterpart of ``scripts/suite_feasibility.py``, with its flags,
defaults and printed lines: the blind ground-balance LQR (or, with
``--scheduled``, the gain-scheduled LQR; with ``--cem``, a per-draw CEM
refinement on top of it) flies the exact robustness / stress suite draws,
and its strict success rate is reported against the analytic feasibility
classes (climb-away, friction-pinned, equilibrium tilt beyond the window).
``--reroll N`` with ``--obs_noise`` re-rolls each refined controller with
fresh noise; ``--student_view`` restricts the search to the gains the blind
student's observation carries. It runs on CUDA unless ``--cpu`` is given.
``wilson_interval`` (a port addition) gives the 95 % Wilson interval of
several runs' strict successes pooled.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    parser = argparse.ArgumentParser(description="suite feasibility oracle (PyTorch/CUDA port)")
    parser.add_argument("--suite", nargs="*", default=["robustness", "stress"])
    parser.add_argument("--episodes", type=int, default=200)
    parser.add_argument("--steps", type=int, default=0,
                        help="horizon (0 = the suite's own max_episode_steps)")
    parser.add_argument("--seed", type=int, default=0)
    add_device_flags(parser, device_flag=False)
    parser.add_argument("--scheduled", action="store_true",
                        help="use the gain-scheduled privileged LQR teacher")
    parser.add_argument("--cem", action="store_true",
                        help="per-draw CEM refinement on top of the schedule")
    parser.add_argument("--cem_pop", type=int, default=64)
    parser.add_argument("--cem_gens", type=int, default=25)
    parser.add_argument("--cem_horizon", type=int, default=700)
    parser.add_argument("--reroll", type=int, default=0,
                        help="with --cem --obs_noise>0: re-roll each refined controller N "
                             "times with fresh noise and report E[P(win)]")
    parser.add_argument("--obs_noise", type=float, default=0.0,
                        help="model IMU noise inside the CEM scoring rollouts")
    parser.add_argument("--student_view", action="store_true",
                        help="restrict the CEM search to gains on state the blind student's "
                             "observation carries (zero the dz/vz columns and z_eq)")
    parser.add_argument("--cg_max", type=float, default=None)
    parser.add_argument("--wind_max", type=float, default=None)
    parser.add_argument("--mass_var", type=float, default=None)
    parser.add_argument("--thrust_var", type=float, default=None)
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from tvc_ai_torch.dagger_distill import f32
    from tvc_ai_torch.env import rocket_env
    from tvc_ai_torch.eval.evaluate import _suite_env_params
    from tvc_ai_torch.training import cem as cem_mod
    from tvc_ai_torch.training import demos

    dev = resolve_device(device_from_flags(parser, args))
    design = None
    sched = None
    for suite in args.suite:
        params = _suite_env_params(suite)
        overrides = {"cg_offset_max": args.cg_max, "wind_max": args.wind_max,
                     "mass_variation": args.mass_var, "thrust_variation": args.thrust_var}
        overrides = {k: f32(v) for k, v in overrides.items() if v is not None}
        if overrides:
            params = dataclasses.replace(params, randomization=dataclasses.replace(
                params.randomization, **overrides))
            print(f"  [ablation overrides: { {k: float(v) for k, v in overrides.items()} }]")
        if args.scheduled or args.cem:
            # re-synthesized per suite: the stress suite's box needs its own grid
            sched = demos.design_lqr_schedule(params, device=dev).to(dev)
        elif design is None:
            design = demos.design_lqr(params)
        rp = params.rocket
        n = args.episodes
        horizon = args.steps or params.max_episode_steps
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        states, _ = rocket_env.reset(params, n, dev, generator=gen)
        d0 = torch.zeros((n, 3), dtype=torch.float32, device=dev)

        if args.cem:
            ccfg = cem_mod.CEMConfig(pop=args.cem_pop, generations=args.cem_gens,
                                     horizon=args.cem_horizon, obs_noise_std=args.obs_noise)
            theta0 = cem_mod.theta_for_states(sched, states)
            mask = None
            if args.student_view:
                # dz/vz columns at 1, 4 (yaw) and 7, 10 (pitch); z_eq (14) feeds dz only
                mask = torch.ones(cem_mod.THETA_DIM, device=dev)
                mask[[1, 4, 7, 10, 14]] = 0.0
            t0 = time.time()
            cem_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
            theta, score = cem_mod.refine_per_draw(params, states, theta0, ccfg,
                                                   theta_mask=mask, generator=cem_gen)
            ok = (score >= 0.5 * ccfg.success_bonus).cpu().numpy()
            print(f"== {suite} suite ({n} episodes, CEM oracle) ==")
            print(f"  [CEM refine: pop {ccfg.pop} x gens {ccfg.generations} "
                  f"x horizon {ccfg.horizon}, {time.time() - t0:.0f}s]")
            _report(args, params, rp, states, ok, np)
            if args.reroll > 0 and args.obs_noise > 0:
                wins = np.zeros(n)
                for r in range(args.reroll):
                    s = cem_mod.rollout_score(
                        theta, states, params, ccfg,
                        generator=torch.Generator(device=dev).manual_seed(args.seed + 7 + r))
                    wins += (s >= 0.5 * ccfg.success_bonus).cpu().numpy()
                p_win = wins / args.reroll
                print(f"  honest re-rolled ceiling ({args.reroll} fresh-noise re-rolls/draw): "
                      f"E[P(win)] = {p_win.mean():.2%}; P(win|solved-once) = "
                      f"{p_win[ok].mean() if ok.any() else 0.0:.2%}; "
                      f"draws with P(win)>=0.5: {(p_win >= 0.5).mean():.2%}")
            continue

        ok = first_episode_success(states, params, horizon, gen, rp, d0, design, sched)
        print(f"== {suite} suite ({n} episodes, horizon {horizon}) ==")
        _report(args, params, rp, states, ok, np)
    return 0


def wilson_interval(k: int, n: int, level: float = 0.95) -> tuple[float, float]:
    """The Wilson score interval of ``k`` successes in ``n`` trials."""
    from statistics import NormalDist

    z = NormalDist().inv_cdf(0.5 + level / 2)
    p, zz = k / n, z * z / n
    center = (p + zz / 2) / (1 + zz)
    half = z * math.sqrt(p * (1 - p) / n + zz / (4 * n)) / (1 + zz)
    return max(center - half, 0.0), min(center + half, 1.0)


def first_episode_success(states, params, horizon: int, gen, rp, d0, design, sched):
    """Each env slot's first-episode strict outcome (one suite episode each)
    under the fixed or the scheduled LQR, through ``batched_step_autoreset``
    (K1 on the card); a slot still in its first episode at the horizon
    counts its last step's flag."""
    import torch

    from tvc_ai_torch.env import rocket_env
    from tvc_ai_torch.training import demos

    n = d0.shape[0]
    ended = torch.zeros(n, dtype=torch.bool, device=d0.device)
    first = torch.zeros(n, dtype=torch.bool, device=d0.device)
    with torch.no_grad():
        for _ in range(horizon):
            if sched is not None:
                act = demos.lqr_action_scheduled(states.body, sched, states.dr.mass,
                                                  states.dr.thrust_scale, d0, rp)
            else:
                act = demos.lqr_action(states.body, design, d0, rp)
            states, out, _ = rocket_env.batched_step_autoreset(states, act, params,
                                                               generator=gen)
            done = out.terminated | out.truncated
            first = torch.where(~ended & done, out.mission_success, first)
            ended = ended | done
            last = out.mission_success
    return torch.where(ended, first, last).cpu().numpy()


def _report(args, params, rp, states, ok, np):
    """Strict success against the analytic feasibility classes: climb-away
    (thrust above the double-gravity weight), friction-pinned (stiction
    above the maximal lateral thrust) and the equilibrium tilt beyond the
    5-degree window at the draw's CG offset."""
    ok = np.asarray(ok)
    mass = states.dr.mass.cpu().numpy()
    cg = states.dr.cg_offset.cpu().numpy()
    cg_mag = np.linalg.norm(cg[:, :2], axis=1)
    tscale = states.dr.thrust_scale.cpu().numpy()
    g_eff = 2.0 * float(rp.gravity)
    mu = float(rp.contact_friction)
    sin_g = math.sin(float(rp.max_gimbal))
    thrust = tscale * float(rp.thrust)
    climb_away = thrust > mass * g_eff
    pinned = mu * (mass * g_eff - thrust) > thrust * sin_g
    theta_eq = np.arctan(2.0 * thrust * cg_mag / (mass * g_eff))
    tilt_infeasible = theta_eq > 0.087  # strict window tilt bound
    infeasible = climb_away | pinned | tilt_infeasible
    feas = ~infeasible
    print(f"  physics-infeasible: {infeasible.mean():.1%} "
          f"(climb-away {climb_away.mean():.1%}, "
          f"friction-pinned {pinned.mean():.1%}, "
          f"equilibrium tilt > 5deg {tilt_infeasible.mean():.1%})")
    print(f"  strict success: {ok.mean():.1%} overall; "
          f"{ok[feas].mean() if feas.any() else 0:.1%} on feasible draws; "
          f"{ok[infeasible].mean() if infeasible.any() else 0:.1%} on "
          f"infeasible draws (analytic labels are approximate at the band edges)")
    for lo, hi in [(0, 0.02), (0.02, 0.035), (0.035, 0.05), (0.05, 0.2)]:
        m = (cg_mag >= lo) & (cg_mag < hi) & ~climb_away & ~pinned
        if m.sum():
            print(f"    |cg| in [{lo:.3f},{hi:.3f}) n={m.sum():4d} success={ok[m].mean():.1%}")


if __name__ == "__main__":
    raise SystemExit(main())
