"""Build a greedy set-cover controller library for the identification pilot.

    python -m tvc_ai_torch.build_ctrl_library --episodes 1024 --k 24 \\
        [--suite robustness] [--out tvc_ai_torch/data/ctrl_library_robustness.npz] [--cpu]

The counterpart of ``scripts/build_ctrl_library.py``, with its flags,
defaults and printed lines: CEM-solve a draw batch, build the controller ×
draw transfer matrix on the solved set, take a greedy set cover ordered by
marginal coverage (member 0 the best single controller), validate on fresh
draws and write an ``.npz`` with the reference's keys (``theta`` (K, 15)
float32 and the construction statistics), which ``python -m
tvc_ai_torch.pilot_eval --library`` reads. It runs on CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    p = argparse.ArgumentParser(description="controller library (PyTorch/CUDA port)")
    p.add_argument("--suite", default="robustness", choices=["robustness", "stress"])
    p.add_argument("--episodes", type=int, default=1024,
                   help="draws to CEM-solve for library construction")
    p.add_argument("--fresh", type=int, default=512, help="fresh validation draws")
    p.add_argument("--k", type=int, default=24, help="max library size")
    p.add_argument("--max_solved", type=int, default=128,
                   help="cap the transfer-matrix side")
    p.add_argument("--cem_pop", type=int, default=64)
    p.add_argument("--cem_gens", type=int, default=25)
    p.add_argument("--cem_horizon", type=int, default=700)
    p.add_argument("--obs_noise", type=float, default=0.02,
                   help="IMU noise sigma modeled inside CEM scoring (the deployment condition)")
    p.add_argument("--student_view", action="store_true",
                   help="zero the dz/vz gain columns and z_eq (theta indices 1,4,7,10,14)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fresh_seed", type=int, default=1000)
    p.add_argument("--out", default=None)
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
                             horizon=args.cem_horizon, obs_noise_std=args.obs_noise)
    win = 0.5 * ccfg.success_bonus

    def tiled(states, times):
        return tree_map(lambda x: x.repeat(times, *([1] * (x.dim() - 1))), states)

    # 1. the per-draw oracle on the construction batch
    n = args.episodes
    states, _ = rocket_env.reset(params, n, dev,
                                 generator=torch.Generator(device=dev).manual_seed(args.seed))
    theta0 = cem_mod.theta_for_states(sched, states)
    mask = None
    if args.student_view:
        mask = torch.ones(cem_mod.THETA_DIM, device=dev)
        mask[[1, 4, 7, 10, 14]] = 0.0
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    t0 = time.time()
    theta, score = cem_mod.refine_per_draw(params, states, theta0, ccfg, theta_mask=mask,
                                           generator=gen)
    solved = (score >= win).cpu().numpy()
    print(f"{args.suite}: {solved.mean():.1%} of {n} draws solved ({time.time() - t0:.0f}s)",
          flush=True)
    idx = np.nonzero(solved)[0][:args.max_solved]
    m = len(idx)
    if m == 0:
        print("no solved draws — nothing to build")
        return 1

    # 2. the transfer matrix on the solved subset
    sel = torch.as_tensor(idx, device=dev)
    sub_theta = theta[sel]
    t0 = time.time()
    scores = cem_mod.rollout_score(torch.repeat_interleave(sub_theta, m, dim=0),
                                   tiled(tree_map(lambda x: x[sel], states), m), params, ccfg,
                                   generator=gen)
    T = (scores >= win).cpu().numpy().reshape(m, m)
    print(f"transfer matrix {m}x{m}: diagonal {np.diag(T).mean():.1%}, "
          f"off-diag {(T.sum() - np.diag(T).sum()) / max(m * m - m, 1):.1%} "
          f"({time.time() - t0:.0f}s)", flush=True)

    # 3. greedy set cover, ordered by marginal coverage
    covered = np.zeros(m, bool)
    picks: list[int] = []
    while len(picks) < args.k:
        gains = (T & ~covered).sum(1)
        best = int(gains.argmax())
        if gains[best] == 0:
            break
        picks.append(best)
        covered |= T[best]
        print(f"  pick {len(picks):2d}: controller of draw {idx[best]} "
              f"+{gains[best]} draws → cover {covered.mean():.1%}")
    lib = sub_theta[torch.as_tensor(picks, device=dev)]   # (K, THETA_DIM)
    k = len(picks)

    # 4. fresh-draw validation: the library ceiling = any member wins
    f = args.fresh
    fstates, _ = rocket_env.reset(params, f, dev, generator=torch.Generator(
        device=dev).manual_seed(args.fresh_seed))
    t0 = time.time()
    fscores = cem_mod.rollout_score(torch.repeat_interleave(lib, f, dim=0), tiled(fstates, k),
                                    params, ccfg, generator=gen)
    FT = (fscores >= win).cpu().numpy().reshape(k, f)
    lib_ceiling = FT.any(0).mean()
    best_single = FT.sum(1).max() / f
    print(f"fresh {f} draws ({time.time() - t0:.0f}s): library ceiling "
          f"{lib_ceiling:.1%} (any of {k}), best single member "
          f"{best_single:.1%}, member[0] {FT[0].mean():.1%}")

    out = args.out or f"tvc_ai_torch/data/ctrl_library_{args.suite}.npz"
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(
        out,
        theta=lib.cpu().numpy().astype(np.float32),
        suite=np.array(args.suite),
        construction_draws=np.int32(n),
        solved_frac=np.float32(solved.mean()),
        cover_frac=np.float32(covered.mean()),
        fresh_lib_ceiling=np.float32(lib_ceiling),
        fresh_best_single=np.float32(best_single),
        cem_pop=np.int32(ccfg.pop),
        cem_gens=np.int32(ccfg.generations),
        cem_horizon=np.int32(ccfg.horizon),
        obs_noise_std=np.float32(ccfg.obs_noise_std),
        student_view=np.bool_(args.student_view),
        seed=np.int32(args.seed),
    )
    print(f"library ({k} controllers) → {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
