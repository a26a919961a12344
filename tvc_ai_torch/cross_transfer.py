"""Cross-transfer matrix of per-draw CEM controllers.

    python -m tvc_ai_torch.cross_transfer --episodes 512 [--suite robustness] [--cpu]

The counterpart of ``scripts/cross_transfer.py``, with its flags, defaults
and printed lines: CEM-solve a batch of suite draws, then roll every solved
draw's controller on every solved draw (T[i, j]: does controller i win draw
j?) and report the diagonal, the off-diagonal transfer, the best single
controller's coverage and the greedy cover of 90 %. It runs on CUDA unless
``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import time


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    p = argparse.ArgumentParser(description="CEM cross-transfer (PyTorch/CUDA port)")
    p.add_argument("--suite", default="robustness", choices=["robustness", "stress"])
    p.add_argument("--episodes", type=int, default=512)
    p.add_argument("--max_solved", type=int, default=96,
                   help="cap the matrix side (memory: side^2 envs roll at once)")
    p.add_argument("--cem_pop", type=int, default=64)
    p.add_argument("--cem_gens", type=int, default=25)
    p.add_argument("--cem_horizon", type=int, default=700)
    p.add_argument("--obs_noise", type=float, default=0.0,
                   help="IMU-noise sigma inside CEM refinement AND the transfer rollouts")
    p.add_argument("--cem_alive", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    add_device_flags(p, device_flag=False)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from tvc_ai_torch.env import rocket_env
    from tvc_ai_torch.eval.evaluate import _suite_env_params
    from tvc_ai_torch.training import cem as cem_mod
    from tvc_ai_torch.training import demos
    from tvc_ai_torch.utils.tree import tree_map

    dev = resolve_device(device_from_flags(p, args))
    params = _suite_env_params(args.suite)
    sched = demos.design_lqr_schedule(params, device=dev).to(dev)
    ccfg = cem_mod.CEMConfig(pop=args.cem_pop, generations=args.cem_gens,
                             horizon=args.cem_horizon, obs_noise_std=args.obs_noise,
                             alive_weight=args.cem_alive)
    n = args.episodes
    states, _ = rocket_env.reset(params, n, dev,
                                 generator=torch.Generator(device=dev).manual_seed(args.seed))
    theta0 = cem_mod.theta_for_states(sched, states)
    t0 = time.time()
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    theta, score = cem_mod.refine_per_draw(params, states, theta0, ccfg, generator=gen)
    solved = (score >= 0.5 * ccfg.success_bonus).cpu().numpy()
    idx = np.nonzero(solved)[0][:args.max_solved]
    m = len(idx)
    print(f"{args.suite}: {solved.mean():.1%} solved; transfer matrix on {m} draws "
          f"({time.time() - t0:.0f}s refine)", flush=True)
    if m == 0:
        return 0
    sel = torch.as_tensor(idx, device=dev)
    sub_states = tree_map(lambda x: x[sel], states)
    # rows = controllers, cols = draws: the draw index varies fastest
    rep_states = tree_map(lambda x: x.repeat(m, *([1] * (x.dim() - 1))), sub_states)
    rep_theta = torch.repeat_interleave(theta[sel], m, dim=0)
    scores = cem_mod.rollout_score(rep_theta, rep_states, params, ccfg, generator=gen)
    T = (scores >= 0.5 * ccfg.success_bonus).cpu().numpy().reshape(m, m)

    cover_best = T.sum(1).max() / m
    covered = np.zeros(m, bool)
    picks = 0
    while covered.mean() < 0.9 and picks < m:
        gains = (T & ~covered).sum(1)
        best = int(gains.argmax())
        if gains[best] == 0:
            break
        covered |= T[best]
        picks += 1
    print(f"diagonal (own draw): {np.diag(T).mean():.1%}")
    print(f"off-diagonal transfer: {(T.sum() - np.diag(T).sum()) / max(m * m - m, 1):.1%}")
    print(f"best single controller covers {cover_best:.1%} of solved draws")
    print(f"greedy cover of 90% needs {picks} controllers (reached {covered.mean():.1%})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
