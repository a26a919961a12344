"""LQR ground-balance synthesis: the CG-axis feasibility probe.

    python -m tvc_ai_torch.lqr_balance [--cpu] [--mode blind|privileged] \\
        [--cg 0.0 0.01 0.025 0.04 0.045] [--steps 900] [--seed 0] [--verbose]

The counterpart of ``scripts/lqr_balance.py``, with its flags, defaults,
printed lines and exit code: ``training.demos.design_lqr`` synthesizes the
per-plane LQR about the standing equilibrium from the true step map (on the
host CPU), and one episode per CG offset verifies it on the full nonlinear
env through the single-env core (``env.single.SingleEnv``: K1 at N = 1 on
the card, one host read per step). ``blind`` tells the controller no offset;
``privileged`` tells it the true one. It returns 1 when any offset fails the
strict 100-step window, else 0. It runs on CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import math


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    parser = argparse.ArgumentParser(description="LQR balance probe (PyTorch/CUDA port)")
    parser.add_argument("--cg", type=float, nargs="*", default=[0.0, 0.01, 0.025, 0.04, 0.045])
    parser.add_argument("--mode", choices=["blind", "privileged"], default="blind")
    parser.add_argument("--steps", type=int, default=900)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--verbose", action="store_true")
    add_device_flags(parser, device_flag=False)
    args = parser.parse_args(argv)

    from tvc_ai_torch.diagnose_cg import env_params

    dev = resolve_device(device_from_flags(parser, args))
    return probe(env_params(), args.cg, args.mode, args.steps, args.seed, args.verbose, dev)


def probe(params, cgs, mode: str, steps: int, seed: int, verbose: bool, device,
          reset_draws=None) -> int:
    """The probe over ``cgs``, printed as the reference prints it; every
    episode resets from a generator seeded ``seed`` (or ``reset_draws``).
    Returns the exit code."""
    import numpy as np
    import torch

    from tvc_ai_torch.diagnose_cg import WindowBooks
    from tvc_ai_torch.env.single import SingleEnv
    from tvc_ai_torch.training import demos

    rp = params.rocket
    design = demos.design_lqr(params)
    if verbose:
        theta0 = demos.equilibrium_tilt(params, 0.025)
        print(f"equilibrium tilt at d=0.025: {math.degrees(theta0):.3f} deg "
              f"(analytic -2Td/mg: "
              f"{math.degrees(math.atan(-2 * 35 * 0.025 / (2 * 2 * 9.81))):.3f})")
        print("LQR gain:", np.asarray(design.gain))

    # the design as (1, ·) device tensors, made once: no host copy per step
    on_device = demos.LQRDesign(*(torch.as_tensor(np.array(f, np.float32)[None], device=device)
                                  for f in design))
    any_fail = False
    for cg_mag in cgs:
        env = SingleEnv(params, device, seed=seed)
        env.reset(reset_draws)
        env.replace_dr(cg_offset=[cg_mag, 0.0, 0.0])
        d_known = (env.state.dr.cg_offset.clone() if mode == "privileged"
                   else torch.zeros((1, 3), device=env.device))
        books = WindowBooks(params, 1, env.device)

        def extra(state, out):
            books.update(t, state, out)
            return {"tilt": out.tilt, "w": out.angular_velocity_mag, "alt": out.altitude,
                    "hv": torch.linalg.vector_norm(state.body.vel[:, :2], dim=-1),
                    "vz": state.body.vel[:, 2], "ok": books.ok_run, "done": books.done}

        for t in range(steps):
            act = demos.lqr_action(env.state.body, on_device, d_known, rp)
            x = env.step(act, extra=extra).extra
            if verbose and t % 50 == 0:
                print(f"  t={t} tilt={math.degrees(float(x['tilt'][0])):.2f}deg "
                      f"|w|={float(x['w'][0]):.3f} alt={float(x['alt'][0]):.3f} "
                      f"hvel={float(x['hv'][0]):.3f} vz={abs(float(x['vz'][0])):.3f} "
                      f"ok={int(x['ok'][0])}")
            if bool(x["done"][0]):
                break
        (success_at, died_at, best), = books.results()
        status = (f"SUCCESS at t={success_at}" if success_at is not None
                  else f"died at t={died_at}" if died_at is not None
                  else "survived horizon, no window")
        if success_at is None:
            any_fail = True
        print(f"cg={cg_mag:.3f} [lqr/{mode}]: {status} "
              f"(best in-window run {best}/100)")
    return 1 if any_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
