"""Scripted trim+PD / cascade / integral controller: the classical-control
feasibility probe.

    python -m tvc_ai_torch.scripted_controller [--cpu] [--variant pd|cascade|integral] \\
        [--cg 0.0 0.01 0.025 0.04] [--kp 5] [--kd 2] [--kv 0.2] [--kx 0.5] [--ki 1.0] \\
        [--steps 900] [--seed 0] [--search] [--verbose]

The counterpart of ``scripts/scripted_controller.py``, with its flags,
defaults, printed lines and exit code: an attitude PD with the exact trim
feedforward (``pd``), plus a proportional velocity cascade (``cascade``), plus
a drift-integral outer loop and an attitude integral (``integral``), flies one
episode per fixed CG offset; ``--search`` tries the variant's gain grid at
each offset and reports the first passing gain set in ``itertools.product``
order, else the best by (passed, best in-window run), ties kept by the
earlier set. The port flies every gain set of the grid as one row of a single
batch through ``rocket_env.batched_step`` (K1 on the card; the rows are
independent, so each row's outcome is the sequential rollout's), and reads
the rows' books every 32 steps to stop once all have ended. It returns 1 when
any offset has no passing run, else 0. It runs on CUDA unless ``--cpu`` is
given.
"""

from __future__ import annotations

import argparse
import itertools
import math

CHECK_EVERY = 32   # steps between the reads of "every row has ended"
GRIDS = {
    "pd": ([3.0, 5.0, 8.0], [1.0, 2.0], [0.0], [0.0], [0.0]),
    "cascade": ([5.0], [2.0], [0.1, 0.2, 0.4], [0.0], [0.0]),
    "integral": ([5.0, 8.0], [1.5, 2.0], [0.15, 0.3, 0.5], [0.3, 0.6, 1.2], [0.5, 1.0, 2.0]),
}


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    parser = argparse.ArgumentParser(description="scripted controller probe (PyTorch/CUDA port)")
    parser.add_argument("--cg", type=float, nargs="*", default=[0.0, 0.01, 0.025, 0.04])
    parser.add_argument("--variant", choices=["pd", "cascade", "integral"], default="pd")
    parser.add_argument("--kp", type=float, default=5.0)
    parser.add_argument("--kd", type=float, default=2.0)
    parser.add_argument("--kv", type=float, default=0.2,
                        help="velocity gain (cascade/integral variants)")
    parser.add_argument("--kx", type=float, default=0.5,
                        help="velocity-integral (drift) gain (integral variant)")
    parser.add_argument("--ki", type=float, default=1.0,
                        help="attitude-integral gain (integral variant)")
    parser.add_argument("--steps", type=int, default=900)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--search", action="store_true",
                        help="grid-search gains at each cg, report the best")
    parser.add_argument("--verbose", action="store_true")
    add_device_flags(parser, device_flag=False)
    args = parser.parse_args(argv)

    from tvc_ai_torch.diagnose_cg import env_params

    dev = resolve_device(device_from_flags(parser, args))
    gains = (args.kp, args.kd, args.kv, args.kx, args.ki)
    return probe(env_params(), args.cg, args.variant, gains, args.steps, args.seed,
                 args.search, args.verbose, dev)


def controller(body, cg, gains, ctrl, variant: str, max_gimbal: float, thrust: float,
               dt: float):
    """One control step of N rows: ``cg`` (N, 3), ``gains`` (N, 5) =
    (kp, kd, kv, kx, ki), ``ctrl`` = (attitude integral (N, 2), velocity
    integral (N, 2)). Returns (actions (N, 2), ctrl)."""
    import torch

    from tvc_ai_torch.physics import quaternion as quat

    kp, kd, kv, kx, ki = (g[:, None] for g in gains.unbind(-1))
    att_i, vel_i = ctrl
    q, w = body.quat, body.omega
    ff_pitch = torch.arcsin(torch.clamp(2.0 * cg[:, 1], -0.9, 0.9))
    ff_yaw = torch.arcsin(torch.clamp(2.0 * cg[:, 0], -0.9, 0.9))
    # body-frame thrust direction at the trim gimbal
    f_hat = torch.stack([torch.sin(ff_yaw), torch.sin(ff_pitch),
                         torch.cos(ff_pitch) * torch.cos(ff_yaw)], dim=-1)
    f_world = quat.rotate(q, f_hat)
    tgt = torch.zeros_like(f_world)
    tgt[:, 2] = 1.0
    if variant in ("cascade", "integral"):
        v = body.vel
        tip = -kv * v[:, :2]
        if variant == "integral":
            # velocity integral == position drift with anti-windup
            vel_i = torch.clamp(vel_i + v[:, :2] * dt, -1.0, 1.0)
            tip = tip - kx * vel_i
        tgt = torch.cat([tip, torch.ones_like(tip[:, :1])], dim=-1)
        tgt = tgt / torch.linalg.vector_norm(tgt, dim=-1, keepdim=True)
    e = torch.linalg.cross(f_world, tgt)  # drive the thrust line onto the target
    tau = kp * e - kd * w
    if variant == "integral":
        att_i = torch.clamp(att_i + e[:, :2] * dt, -0.5, 0.5)
        tau = tau + ki * torch.cat([att_i, torch.zeros_like(att_i[:, :1])], dim=-1)
    sp = torch.clamp(tau[:, 0] / (0.5 * thrust), -0.9, 0.9)
    sy = torch.clamp(-tau[:, 1] / (0.5 * thrust), -0.9, 0.9)
    act = torch.stack([(torch.arcsin(sp) + ff_pitch) / max_gimbal,
                       (torch.arcsin(sy) + ff_yaw) / max_gimbal], dim=-1)
    return torch.clamp(act, -1.0, 1.0), (att_i, vel_i)


def rollout(params, cg_mag: float, gains, variant: str, steps: int, seed: int, device,
            verbose: bool = False, reset_draws=None) -> list:
    """One episode per row of ``gains`` (G, 5), every row from the same reset
    (a generator seeded ``seed``, or ``reset_draws`` of one env) with the CG
    offset (cg_mag, 0, 0). Returns each row's (success_at, died_at, best
    in-window run), None where it did not happen."""
    import torch

    from tvc_ai_torch.diagnose_cg import WindowBooks
    from tvc_ai_torch.env import rocket_env
    from tvc_ai_torch.utils.tree import tree_map

    dev = torch.device(device)
    gains = torch.as_tensor(gains, dtype=torch.float32, device=dev).reshape(-1, 5)
    n = gains.shape[0]
    if reset_draws is None:
        reset_draws = rocket_env.draw_reset(params, 1, dev,
                                            torch.Generator(device=dev).manual_seed(seed))
    draws = tree_map(lambda t: t.to(dev).repeat(n, *([1] * (t.dim() - 1))), reset_draws)
    states, _ = rocket_env.reset(params, n, dev, draws=draws)
    cg = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    cg[:, 0] = cg_mag
    states.dr.cg_offset = cg
    rp = params.rocket
    ctrl = (torch.zeros((n, 2), device=dev), torch.zeros((n, 2), device=dev))
    books = WindowBooks(params, n, dev)
    with torch.no_grad():
        for t in range(steps):
            act, ctrl = controller(states.body, cg, gains, ctrl, variant,
                                   float(rp.max_gimbal), float(rp.thrust), float(rp.dt))
            states, out = rocket_env.batched_step(states, act, params)
            live = ~books.done
            books.update(t, states, out)
            if verbose and t % 50 == 0 and bool(live[0]):
                hv = torch.linalg.vector_norm(states.body.vel[0, :2])
                print(f"  t={t} tilt={math.degrees(float(out.tilt[0])):.2f}deg "
                      f"|w|={float(out.angular_velocity_mag[0]):.3f}"
                      f" alt={float(out.altitude[0]):.3f} hvel={float(hv):.3f} "
                      f"ok_run={int(books.ok_run[0])}")
            if (t + 1) % CHECK_EVERY == 0 and bool(books.done.all()):
                break
    return books.results()


def probe(params, cgs, variant: str, gains, steps: int, seed: int, search: bool,
          verbose: bool, device, reset_draws=None) -> int:
    """The probe over ``cgs``, printed as the reference prints it; returns
    the exit code."""
    any_fail = False
    for cg_mag in cgs:
        if search:
            grid = list(itertools.product(*GRIDS[variant]))
            results = rollout(params, cg_mag, grid, variant, steps, seed, device,
                              reset_draws=reset_draws)
            best_gain, best_result = None, (None, None, -1)
            for g, (s, d, b) in zip(grid, results):
                key = (s is not None, b)
                cur = (best_result[0] is not None, best_result[2])
                if key > cur:
                    best_gain, best_result = g, (s, d, b)
                if s is not None:
                    break  # first passing gain set is enough
            success_at, died_at, best = best_result
            gain_part = f" gains={best_gain}"
        else:
            (success_at, died_at, best), = rollout(params, cg_mag, [gains], variant, steps,
                                                   seed, device, verbose, reset_draws)
            gain_part = ""
        status = (f"SUCCESS at t={success_at}" if success_at is not None
                  else f"died at t={died_at}" if died_at is not None
                  else "survived horizon, no window")
        if success_at is None:
            any_fail = True
        print(f"cg={cg_mag:.3f} [{variant}]: {status} "
              f"(best in-window run {best}/100){gain_part}")
    return 1 if any_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
