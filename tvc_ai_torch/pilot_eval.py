"""Evaluate the blind identification pilot on the official suites.

    python -m tvc_ai_torch.pilot_eval --episodes 512 [--suite robustness]
        [--particles 192] [--replan 50,300] [--library LIB.npz --select 25,150]
        [--diag] [--cpu]

The counterpart of ``scripts/pilot_eval.py``, with its flags, defaults and
printed lines: the pilot (``training.pilot``: a particle filter over the
domain draw feeding the gain-scheduled LQR) flies the suite's episodes from
the observation stream alone, replanning by per-draw CEM at the ``--replan``
steps, or, with ``--library`` (``tvc_ai_torch/data/ctrl_library_robustness.npz``
is the port's copy of the reference's), starting on library member 0 and
selecting a member by posterior-scored rollouts at the ``--select`` steps.
Every filter step is one K1 launch over episodes × particles rows; the
selection runs eagerly, as in the reference. One extra line gives the
filter's and the replans' seconds. It runs on CUDA unless ``--cpu`` is
given.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    p = argparse.ArgumentParser(description="identification pilot eval (PyTorch/CUDA port)")
    p.add_argument("--suite", default="robustness", choices=["robustness", "stress"])
    p.add_argument("--episodes", type=int, default=512)
    p.add_argument("--steps", type=int, default=0,
                   help="horizon (0 = the suite's max_episode_steps)")
    p.add_argument("--particles", type=int, default=192)
    p.add_argument("--replan", default="50,300",
                   help="comma-separated step indices for CEM replanning ('' = never)")
    p.add_argument("--cem_pop", type=int, default=64)
    p.add_argument("--cem_gens", type=int, default=25)
    p.add_argument("--cem_horizon", type=int, default=700)
    p.add_argument("--sigma_drift", type=float, default=0.02)
    p.add_argument("--jitter_frac", type=float, default=0.25)
    p.add_argument("--library", default=None,
                   help="controller-library .npz (build_ctrl_library): start on library[0] "
                        "and posterior-select at the --select step indices")
    p.add_argument("--select", default="25,150",
                   help="comma-separated step indices for library selection")
    p.add_argument("--select_samples", type=int, default=8,
                   help="posterior particles scored per selection")
    p.add_argument("--select_horizon", type=int, default=500,
                   help="model-rollout length per selection score")
    p.add_argument("--select_noise", type=float, default=0.0,
                   help="obs_noise_std for the selection scoring rollouts")
    p.add_argument("--state_from_obs", action="store_true",
                   help="feed the control law the raw observed state")
    p.add_argument("--oracle_dr", action="store_true",
                   help="PROBE (privileged): replan on the episode's TRUE draw")
    p.add_argument("--oracle_state", action="store_true",
                   help="PROBE (privileged): replan from the episode's TRUE body state/fuel")
    p.add_argument("--cg_offset_max", type=float, default=None)
    p.add_argument("--sensor_noise", type=int, default=None,
                   help="override suite sensor noise (0/1)")
    p.add_argument("--seed", type=int, default=0)
    add_device_flags(p, device_flag=False)
    p.add_argument("--diag", action="store_true",
                   help="print identification error vs the true draw at each replan")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from tvc_ai_torch.env import rocket_env
    from tvc_ai_torch.eval.evaluate import _suite_env_params
    from tvc_ai_torch.eval.rollout import _freeze
    from tvc_ai_torch.training import cem as cem_mod
    from tvc_ai_torch.training import demos
    from tvc_ai_torch.training import pilot as pilot_mod

    dev = resolve_device(device_from_flags(p, args))
    params = _suite_env_params(
        args.suite, obs_overrides={"drift_obs_enabled": True}, cg_offset_max=args.cg_offset_max,
        sensor_noise=None if args.sensor_noise is None else bool(args.sensor_noise))
    sched = demos.design_lqr_schedule(params, device=dev).to(dev)
    pcfg = pilot_mod.PilotConfig(particles=args.particles, sigma_drift=args.sigma_drift,
                                 jitter_frac=args.jitter_frac,
                                 state_from_obs=args.state_from_obs)
    ccfg = cem_mod.CEMConfig(pop=args.cem_pop, generations=args.cem_gens,
                             horizon=args.cem_horizon)
    library = None
    if args.library:
        with np.load(args.library, allow_pickle=False) as blob:
            library = torch.tensor(blob["theta"], dtype=torch.float32, device=dev)
            print(f"library: {library.shape[0]} controllers from {args.library} (fresh ceiling "
                  f"{float(blob['fresh_lib_ceiling']):.1%}, best single "
                  f"{float(blob['fresh_best_single']):.1%})")
        events = [int(s) for s in args.select.split(",") if s.strip()]
    else:
        events = [int(s) for s in args.replan.split(",") if s.strip()]
    horizon = args.steps or params.max_episode_steps
    n = args.episodes

    def gen(offset):
        return torch.Generator(device=dev).manual_seed(args.seed + offset)

    env_gen = gen(0)
    states, obs0 = rocket_env.reset(params, n, dev, generator=env_gen)
    true_dr = states.dr   # for --diag and the breakdown only
    pilot_gen = gen(1)
    ps = pilot_mod.init_pilot(obs0, params, pcfg, generator=pilot_gen)
    if library is not None:
        # the pre-identification strategy: the best-coverage member
        ps = dataclasses.replace(ps, theta=library[0].expand(n, -1).clone(),
                                 has_theta=torch.ones_like(ps.has_theta))
    # the replans' shape template (its contents are overwritten by the
    # pilot's own estimates)
    template, _ = rocket_env.reset(params, n, dev, generator=gen(2))
    replan_gen = gen(3)

    if library is not None:
        score_cfg = cem_mod.CEMConfig(horizon=args.select_horizon, alive_weight=0.1,
                                      obs_noise_std=args.select_noise)

        def _replan(ps, st):
            return pilot_mod.select_from_library(
                ps, library, params, score_cfg, template, n_samples=args.select_samples,
                bodies=st.body if args.oracle_state else None,
                drs=st.dr if args.oracle_dr else None,
                fuel=st.fuel if args.oracle_state else None, generator=replan_gen)
    else:
        def _replan(ps, st):
            bodies = st.body if args.oracle_state else pilot_mod.estimate_body(ps.filt)
            drs = st.dr if args.oracle_dr else pilot_mod.estimate_dr(ps.filt)
            fuel = st.fuel if args.oracle_state else ps.filt.fuel
            return pilot_mod.replan_from(ps, bodies, drs, fuel, sched, params, ccfg, template,
                                         generator=replan_gen)

    done = torch.zeros(n, dtype=torch.bool, device=dev)
    succ = torch.zeros(n, dtype=torch.bool, device=dev)
    event_steps = {t for t in events if 0 < t < horizon}
    t0 = time.time()
    filter_s = event_s = 0.0
    with torch.no_grad():
        for t in range(horizon):
            if t in event_steps:
                if args.diag:
                    _diag(ps, true_dr, done, t, pilot_mod, np)
                te = time.time()
                ps = _replan(ps, states)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                event_s += time.time() - te
            ts = time.time()
            ps, act = pilot_mod.pilot_act(ps, sched, params, pcfg)
            nxt, out = rocket_env.batched_step(states, act, params, generator=env_gen)
            succ = succ | (~done & out.mission_success)
            states = _freeze(done, nxt, states)
            done = done | out.terminated | out.truncated
            ps = pilot_mod.pilot_observe(ps, out.obs, params, pcfg, generator=pilot_gen)
            filter_s += time.time() - ts
    ok = succ.cpu().numpy()
    dt = time.time() - t0
    tags = "".join(f" {t}" for t, on in [("obs-state", args.state_from_obs),
                                          ("ORACLE-DR", args.oracle_dr),
                                          ("ORACLE-STATE", args.oracle_state)] if on)
    mode = (f"select@{events} K={library.shape[0]}" if library is not None
            else f"replan@{events}")
    print(f"== {args.suite} suite: pilot strict success {ok.mean():.1%} ({int(ok.sum())}/{n}, "
          f"{dt:.0f}s, P={args.particles}, {mode}{tags}) ==")
    print(f"  [pilot: {horizon} filter steps in {filter_s:.3f}s = "
          f"{filter_s / max(horizon, 1) * 1e3:.2f} ms/step at {n} x {args.particles} particles; "
          f"{len(event_steps)} {'selections' if library is not None else 'replans'} in "
          f"{event_s:.3f}s]")
    _breakdown(params, true_dr, ok, np)
    return 0


def _diag(ps, true_dr, done, t, pilot_mod, np):
    est = pilot_mod.estimate_dr(ps.filt)
    live = ~done.cpu().numpy()
    if live.sum() == 0:
        return

    def a(x):
        return x.cpu().numpy()

    em = np.abs(a(est.mass - true_dr.mass))[live]
    et = np.abs(a(est.thrust_scale - true_dr.thrust_scale))[live]
    ec = np.linalg.norm(a(est.cg_offset - true_dr.cg_offset)[:, :2], axis=1)[live]
    ew = np.linalg.norm(a(est.wind - true_dr.wind)[:, :2], axis=1)[live]
    print(f"  [t={t} id-error (live {live.sum()}): mass {np.median(em):.3f} kg, thrust "
          f"{np.median(et):.3f}, cg {np.median(ec)*1000:.1f} mm, wind {np.median(ew):.2f} N "
          f"(medians)]")


def _breakdown(params, dr, ok, np):
    """The feasibility-class breakdown (``suite_feasibility``'s labels)."""
    rp = params.rocket
    mass = dr.mass.cpu().numpy()
    tscale = dr.thrust_scale.cpu().numpy()
    cg_mag = np.linalg.norm(dr.cg_offset.cpu().numpy()[:, :2], axis=1)
    g_eff = 2.0 * float(rp.gravity)
    mu = float(rp.contact_friction)
    sin_g = math.sin(float(rp.max_gimbal))
    thrust = tscale * float(rp.thrust)
    climb = thrust > mass * g_eff
    pinned = ~climb & (mu * (mass * g_eff - thrust) > thrust * sin_g)
    eq_tilt = np.arctan(2.0 * thrust * cg_mag / (mass * g_eff))
    tilted = ~climb & ~pinned & (eq_tilt > float(params.success.max_tilt_angle))
    feasible = ~climb & ~pinned & ~tilted
    for name, m in [("feasible", feasible), ("climb-away", climb),
                    ("friction-pinned", pinned), ("eq-tilt>5deg", tilted)]:
        if m.sum():
            print(f"  {name:>15}: {ok[m].mean():6.1%}  ({int(ok[m].sum())}/{int(m.sum())})")


if __name__ == "__main__":
    raise SystemExit(main())
