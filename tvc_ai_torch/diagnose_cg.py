"""Forensic single-episode rollout under a FIXED CG offset.

    python -m tvc_ai_torch.diagnose_cg --model_path RUN/checkpoints_best \\
        [--hidden 256 256] [--history 1] [--trim_obs [--trim_mode ema|integral]] \\
        [--cg 0.0 0.01 0.025 0.05] [--steps 1000] [--cpu]

The counterpart of ``scripts/diagnose_cg.py``, with its flags, defaults and
printed lines: for each CG magnitude one deterministic episode (no other
randomization, no sensor noise) flies through the single-env core
(``env.single.SingleEnv``: K1 at N = 1 on the card, one host read per step),
and the lines say which strict-success criterion fails at the end and how
the episode got there (true tilt against the equilibrium tilt atan(|cg|/L),
horizontal velocity and drift, |ω|, the gimbal command, the in-window run).
The CG offset replaces the reset's draw as a fresh (1, 3) tensor. It runs on
CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    parser = argparse.ArgumentParser(description="fixed-CG forensics (PyTorch/CUDA port)")
    parser.add_argument("--model_path", required=True)
    parser.add_argument("--hidden", type=int, nargs="*", default=[256, 256])
    parser.add_argument("--history", type=int, default=1)
    parser.add_argument("--trim_obs", action="store_true")
    parser.add_argument("--trim_mode", choices=["ema", "integral"], default="ema")
    parser.add_argument("--cg", type=float, nargs="*", default=[0.0, 0.01, 0.025, 0.05])
    parser.add_argument("--steps", type=int, default=1000)
    add_device_flags(parser, device_flag=False)
    args = parser.parse_args(argv)

    from tvc_ai_torch.agents import sac as sac_mod
    from tvc_ai_torch.env.types import OBS_DIM, TRIM_OBS_DIM
    from tvc_ai_torch.eval.evaluate import load_agent_state

    dev = resolve_device(device_from_flags(parser, args))
    sac_cfg = sac_mod.SACConfig(hidden_dims=tuple(args.hidden))
    frame = OBS_DIM + (TRIM_OBS_DIM if args.trim_obs else 0)
    agent = load_agent_state(args.model_path, frame * args.history, 2, sac_cfg, dev)
    diagnose(agent.actor, env_params(args.trim_obs, args.trim_mode), args.cg, args.steps,
             args.history, dev)
    return 0


def env_params(trim_obs: bool = False, trim_mode: str = "ema"):
    """The reference's ``EnvParams()`` (float32), with the trim channels."""
    import dataclasses

    from tvc_ai_torch.env.types import EnvParams, as_float32

    params = as_float32(EnvParams())
    if trim_obs:
        params = dataclasses.replace(params, trim_obs_enabled=True,
                                     trim_obs_integral=trim_mode == "integral")
    return params


class WindowBooks:
    """The probes' books over N rows, on the rows' device: each row's run of
    steps inside ``params.success``'s bounds (strict), its best, and the
    step of its mission success or of its death (a termination without
    success). A row's books stop at its first end."""

    def __init__(self, params, n: int, device):
        import torch

        self.crit = params.success
        self.ok_run = torch.zeros(n, dtype=torch.int32, device=device)
        self.best = torch.zeros_like(self.ok_run)
        self.success_at = torch.full_like(self.ok_run, -1)
        self.died_at = torch.full_like(self.ok_run, -1)
        self.done = torch.zeros(n, dtype=torch.bool, device=device)

    def update(self, t: int, state, out) -> None:
        """Step ``t``'s books from the state after it and its ``StepOutput``."""
        import torch

        crit = self.crit
        hv = torch.linalg.vector_norm(state.body.vel[:, :2], dim=-1)
        vz = torch.abs(state.body.vel[:, 2])
        good = ((out.tilt < crit.max_tilt_angle)
                & (out.angular_velocity_mag < crit.max_angular_velocity)
                & (hv < crit.max_horizontal_velocity)
                & (out.altitude > crit.min_altitude) & (out.altitude < crit.max_altitude)
                & (vz < crit.max_vertical_velocity))
        live = ~self.done
        self.ok_run = torch.where(live, torch.where(good, self.ok_run + 1, 0), self.ok_run)
        self.best = torch.maximum(self.best, self.ok_run)
        self.success_at = torch.where(live & out.mission_success, t, self.success_at)
        self.died_at = torch.where(live & ~out.mission_success & out.terminated, t, self.died_at)
        self.done = self.done | out.mission_success | out.terminated

    def results(self) -> list:
        """Each row's (success_at, died_at, best in-window run), None where
        it did not happen: one read."""
        import torch

        books = torch.stack([self.success_at, self.died_at, self.best], dim=-1).cpu().tolist()
        return [(None if s < 0 else s, None if d < 0 else d, b) for s, d, b in books]


def diagnose(actor, params, cgs, steps: int, history: int, device, reset_draws=None) -> None:
    """One episode per CG magnitude, printed as the reference prints it;
    ``reset_draws`` (one env's) replaces the generator's reset (seed 0)."""
    import math

    import torch

    from tvc_ai_torch.agents import sac as sac_mod
    from tvc_ai_torch.env.single import SingleEnv
    from tvc_ai_torch.physics import quaternion as quat

    crit_cfg = params.success
    max_tilt = float(crit_cfg.max_tilt_angle)
    max_ang = float(crit_cfg.max_angular_velocity)
    max_hvel = float(crit_cfg.max_horizontal_velocity)
    max_vvel = float(crit_cfg.max_vertical_velocity)
    min_alt, max_alt = float(crit_cfg.min_altitude), float(crit_cfg.max_altitude)

    def extra(state, out):
        body = state.body
        return {"tilt": quat.tilt_angle(body.quat),
                "hvel": torch.linalg.vector_norm(body.vel[:, :2], dim=-1),
                "ang": torch.linalg.vector_norm(body.omega, dim=-1),
                "alt": body.pos[:, 2], "vz": body.vel[:, 2],
                "drift": torch.linalg.vector_norm(body.pos[:, :2], dim=-1),
                "success": state.mission_success}

    for cg in cgs:
        env = SingleEnv(params, device, seed=0)
        env.reset(reset_draws)
        env.replace_dr(cg_offset=[cg, 0.0, 0.0])
        window = env.obs.repeat(1, history) if history > 1 else env.obs
        frame = env.obs.shape[-1]
        eq_tilt = math.atan2(cg, 0.5)
        rows = []
        success_steps = 0
        term_reason = "horizon"
        tilt = hvel = ang = 0.0
        alt = float(params.init_pos[2])
        for t in range(steps):
            with torch.no_grad():
                a = sac_mod.select_action(actor, window, deterministic=True)
            r = env.step(a, extra=lambda s, o: {**extra(s, o), "act": a[0]})
            x = r.extra
            tilt, hvel = float(x["tilt"][0]), float(x["hvel"][0])
            ang, alt = float(x["ang"][0]), float(x["alt"][0])
            ok = (
                tilt <= max_tilt
                and ang <= max_ang
                and hvel <= max_hvel
                and abs(float(x["vz"][0])) <= max_vvel
                and min_alt <= alt <= max_alt
            )
            success_steps = success_steps + 1 if ok else 0
            if t % 100 == 0 or t == steps - 1:
                rows.append(
                    f"  t={t:4d} tilt={math.degrees(tilt):6.2f}deg "
                    f"(eq {math.degrees(eq_tilt):5.2f}) alt={alt:5.2f} "
                    f"hvel={hvel:5.2f} |w|={ang:5.2f} "
                    f"act=({float(x['act'][0]):+.2f},{float(x['act'][1]):+.2f}) "
                    f"drift={float(x['drift'][0]):6.2f} "
                    f"okrun={success_steps}"
                )
            if r.terminated:
                term_reason = "success" if bool(x["success"][0]) else "termination"
                rows.append(f"  t={t} TERMINATED ({term_reason})")
                break
            if history > 1:
                window = torch.cat([window[:, frame:], env.obs], dim=-1)
            else:
                window = env.obs
        crit = []
        if tilt > max_tilt:
            crit.append(f"tilt {math.degrees(tilt):.1f}>{math.degrees(max_tilt):.0f}deg")
        if ang > max_ang:
            crit.append(f"|w| {ang:.2f}>{max_ang:g}")
        if hvel > max_hvel:
            crit.append(f"hvel {hvel:.2f}>{max_hvel:g}")
        if not (min_alt <= alt <= max_alt):
            crit.append(f"alt {alt:.2f} outside [{min_alt:g},{max_alt:g}]")
        print(
            f"cg={cg:.3f}: end={term_reason} "
            f"final-fail=[{', '.join(crit) or 'none'}] "
            f"longest-ok-run-at-end={success_steps}"
        )
        for row in rows:
            print(row)


if __name__ == "__main__":
    raise SystemExit(main())
