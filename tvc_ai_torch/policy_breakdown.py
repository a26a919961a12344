"""Per-axis success breakdown of a distilled student on a suite.

    python -m tvc_ai_torch.policy_breakdown --model outputs/dagger_r4/student.pt \\
        [--suite robustness|stress] [--episodes 1024] [--history 8] [--hidden 256 256] \\
        [--trim_obs [--trim_mode ema|integral]] [--seed 0] [--cpu]

The counterpart of ``scripts/policy_breakdown.py``, with its flags, defaults
and printed lines: the policy (a ``student.pt`` in ``SACAgent.save``'s form,
or a ``theta_student.pt``; or the JAX package's ``student.msgpack`` or
``theta_student.msgpack``) flies a batch of suite draws through
``eval.rollout.make_policy_eval_fn`` (K1 on the card), and its strict
success is reported by |cg|, mass and thrust-scale bins against the analytic
feasibility labels (climb-away, friction-pinned, equilibrium tilt beyond
the window). The reference recovers each episode's domain draw by replaying
the eval's key split; the port draws the reset once and hands the same
draws to the rollout. It runs on CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import math

BINS_CG = [(0, 0.005), (0.005, 0.01), (0.01, 0.02), (0.02, 0.035), (0.035, 0.05), (0.05, 0.2)]


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    p = argparse.ArgumentParser(description="per-axis success breakdown (PyTorch/CUDA port)")
    p.add_argument("--model", required=True,
                   help="student.pt / student.msgpack (a SAC state) or theta_student.pt / "
                        "theta_student.msgpack")
    p.add_argument("--suite", default="robustness", choices=["robustness", "stress"])
    p.add_argument("--episodes", type=int, default=1024)
    p.add_argument("--history", type=int, default=8)
    p.add_argument("--hidden", type=int, nargs="*", default=[256, 256])
    p.add_argument("--trim_obs", action="store_true")
    p.add_argument("--trim_mode", choices=["ema", "integral"], default="ema")
    p.add_argument("--seed", type=int, default=0)
    add_device_flags(p, device_flag=False)
    args = p.parse_args(argv)

    import torch

    from tvc_ai_torch.env import rocket_env
    from tvc_ai_torch.eval.rollout import EvalDraws

    dev = resolve_device(device_from_flags(p, args))
    params = suite_params(args.suite, args.trim_obs, args.trim_mode)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    draws = EvalDraws(reset=rocket_env.draw_reset(params, args.episodes, dev, gen))
    policy_fn, agent = load_policy(args.model, params, args.history, args.hidden, dev)
    ok, dr = breakdown(policy_fn, agent, params, args.episodes, args.history, draws, gen)
    report(args.suite, params, ok, dr)
    return 0


def suite_params(suite: str, trim_obs: bool, trim_mode: str):
    """The suite's env with the student's observation channels."""
    from tvc_ai_torch.eval.evaluate import _suite_env_params

    obs_overrides = dict(drift_obs_enabled=True, action_obs_enabled=True)
    if trim_obs:
        obs_overrides.update(trim_obs_enabled=True, trim_obs_integral=trim_mode == "integral")
    return _suite_env_params(suite, obs_overrides=obs_overrides)


def load_policy(path, params, history: int, hidden, dev):
    """``(policy_fn, agent)`` of a θ-student or a SAC student, in this
    package's ``.pt`` form or the JAX package's flax msgpack form (whose
    θ-net params ``convert.theta_net_from_flax`` carries across)."""
    import torch

    from tvc_ai_torch.agents import sac as sac_mod
    from tvc_ai_torch.convert import theta_net_from_flax
    from tvc_ai_torch.env.types import obs_dim
    from tvc_ai_torch.eval.evaluate import load_agent_state
    from tvc_ai_torch.training import theta_student as ts
    from tvc_ai_torch.utils import flax_msgpack

    view_dim = obs_dim(params) * history
    flax_file = flax_msgpack.is_flax_msgpack(path)
    payload = (flax_msgpack.load(path) if flax_file
               else torch.load(path, map_location=dev, weights_only=True))
    if isinstance(payload, dict) and payload.get("kind") == "theta_student":
        tcfg = ts.ThetaDaggerConfig(
            history_len=int(payload["history_len"]),
            hidden_dims=tuple(int(h) for h in payload["hidden_dims"]))
        net = ts.ThetaNet(view_dim, tcfg.hidden_dims, device=dev)
        net.load_state_dict(theta_net_from_flax(payload["params"]) if flax_file
                            else payload["params"])
        return ts.make_theta_policy_fn(params, tcfg), net
    actor = load_agent_state(path, view_dim, 2, sac_mod.SACConfig(hidden_dims=tuple(hidden)),
                             dev).actor

    @torch.no_grad()
    def policy_fn(actor_, obs):
        return sac_mod.select_action(actor_, obs, deterministic=True)

    return policy_fn, actor


def breakdown(policy_fn, agent, params, episodes: int, history: int, draws, generator=None):
    """Each episode's strict success and its domain draw ((E,) numpy bool,
    the reset's ``DomainParams``), both from ``draws``."""
    from tvc_ai_torch.env import rocket_env
    from tvc_ai_torch.eval.rollout import make_policy_eval_fn

    dev = draws.reset.u_init.device
    states, _ = rocket_env.reset(params, episodes, dev, draws=draws.reset)
    eval_fn = make_policy_eval_fn(policy_fn, episodes, history_len=history)
    stats = eval_fn(agent, generator, params, draws)
    return stats.success.cpu().numpy().astype(bool), states.dr


def report(suite: str, params, ok, dr) -> None:
    """The reference's lines: overall, then by |cg|, mass and thrust scale."""
    import numpy as np

    rp = params.rocket
    mass = dr.mass.cpu().numpy()
    tscale = dr.thrust_scale.cpu().numpy()
    cg = dr.cg_offset.cpu().numpy()
    cg_mag = np.linalg.norm(cg[:, :2], axis=1)
    g_eff = 2.0 * float(rp.gravity)
    mu = float(rp.contact_friction)
    sin_g = math.sin(float(rp.max_gimbal))
    thrust = tscale * float(rp.thrust)
    climb = thrust > mass * g_eff
    pinned = mu * (mass * g_eff - thrust) > thrust * sin_g
    theta_eq = np.arctan(2.0 * thrust * cg_mag / (mass * g_eff))
    infeas = climb | pinned | (theta_eq > 0.087)
    feas = ~infeas

    print(f"== {suite}: {ok.mean():.2%} strict overall "
          f"({ok[feas].mean() if feas.any() else 0:.2%} on analytically "
          f"feasible draws, {feas.mean():.1%} of the box) ==")
    print("by |cg| (feasible draws only):")
    for lo, hi in BINS_CG:
        m = (cg_mag >= lo) & (cg_mag < hi) & feas
        if m.sum():
            print(f"  [{lo:.3f},{hi:.3f}) n={m.sum():4d} "
                  f"success={ok[m].mean():.1%}")
    print("by mass (feasible draws only):")
    edges = np.quantile(mass[feas], [0, 0.25, 0.5, 0.75, 1.0])
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (mass >= lo) & (mass <= hi) & feas
        if m.sum():
            print(f"  [{lo:.2f},{hi:.2f}] n={m.sum():4d} "
                  f"success={ok[m].mean():.1%}")
    print("by thrust scale (feasible draws only):")
    edges = np.quantile(tscale[feas], [0, 0.25, 0.5, 0.75, 1.0])
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (tscale >= lo) & (tscale <= hi) & feas
        if m.sum():
            print(f"  [{lo:.2f},{hi:.2f}] n={m.sum():4d} "
                  f"success={ok[m].mean():.1%}")


if __name__ == "__main__":
    raise SystemExit(main())
