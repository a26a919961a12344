"""Post-hoc student reselection with large independent evaluations.

    python -m tvc_ai_torch.select_student --dir outputs/dagger_r5 \\
        [--episodes 512] [--history 8] [--hidden 256 256] [--cpu]

The counterpart of ``scripts/select_student.py``, with its flags, defaults
and printed lines: every saved candidate (``student*.pt`` from
``python -m tvc_ai_torch.dagger_distill --save_every``, and the JAX
package's ``student*.msgpack``) is evaluated on the official suite
with a held-out seed, and the winner is confirmed on a second, disjoint
seed; ``selection_<suite>.json`` records the rows and the confirmed winner
is copied to ``student_selected_<suite>`` with its own suffix. It runs on
CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    p = argparse.ArgumentParser(description="student reselection (PyTorch/CUDA port)")
    p.add_argument("--dir", required=True)
    p.add_argument("--episodes", type=int, default=512)
    p.add_argument("--confirm_episodes", type=int, default=1024)
    p.add_argument("--history", type=int, default=8)
    p.add_argument("--hidden", type=int, nargs="*", default=[256, 256])
    p.add_argument("--suite", default="robustness", choices=["robustness", "stress"])
    p.add_argument("--select_seed", type=int, default=1001)
    p.add_argument("--confirm_seed", type=int, default=2002)
    add_device_flags(p, device_flag=False)
    args = p.parse_args(argv)

    import torch

    from tvc_ai_torch.agents import sac as sac_mod
    from tvc_ai_torch.env.types import obs_dim as obs_dim_of
    from tvc_ai_torch.eval import rollout as rollout_mod
    from tvc_ai_torch.eval.evaluate import _suite_env_params, load_agent_state

    dev = resolve_device(device_from_flags(p, args))
    out = Path(args.dir)
    candidates = sorted([*out.glob("student*.pt"), *out.glob("student*.msgpack")])
    if not candidates:
        print(f"no student*.pt or student*.msgpack under {out}", file=sys.stderr)
        return 1
    params = _suite_env_params(args.suite, obs_overrides=dict(drift_obs_enabled=True,
                                                              action_obs_enabled=True))
    view_dim = obs_dim_of(params) * args.history
    sac_cfg = sac_mod.SACConfig(hidden_dims=tuple(args.hidden))

    @torch.no_grad()
    def policy_fn(actor, obs):
        return torch.tanh(actor(obs)[0])

    eval_sel = rollout_mod.make_policy_eval_fn(policy_fn, args.episodes, history_len=args.history)
    eval_confirm = rollout_mod.make_policy_eval_fn(policy_fn, args.confirm_episodes,
                                                   history_len=args.history)

    def load(path):
        return load_agent_state(path, view_dim, 2, sac_cfg, dev).actor

    def rate(fn, actor, seed):
        stats = fn(actor, torch.Generator(device=dev).manual_seed(seed), params)
        return float(stats.success.float().mean())

    rows = []
    for c in candidates:
        actor = load(c)
        t0 = time.time()
        sr = rate(eval_sel, actor, args.select_seed)
        rows.append({"candidate": c.name, "select_success": sr})
        print(f"{c.name}: {sr:.2%} on {args.episodes} episodes ({time.time() - t0:.0f}s)",
              flush=True)
    rows.sort(key=lambda r: -r["select_success"])
    winner = rows[0]
    confirm = rate(eval_confirm, load(out / winner["candidate"]), args.confirm_seed)
    winner["confirm_success"] = confirm
    winner["confirm_episodes"] = args.confirm_episodes
    print(f"winner {winner['candidate']}: select {winner['select_success']:.2%} -> confirm "
          f"{confirm:.2%} ({args.confirm_episodes} episodes, disjoint seed)")
    (out / f"selection_{args.suite}.json").write_text(
        json.dumps({"rows": rows, "winner": winner}, indent=2))
    # the confirmed winner becomes the canonical per-suite artifact
    best_path = out / f"student_selected_{args.suite}{Path(winner['candidate']).suffix}"
    shutil.copyfile(out / winner["candidate"], best_path)
    print(f"saved {best_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
