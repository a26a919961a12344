"""One-command PyBullet parity gate (the physics-fidelity gate).

    python -m tvc_ai_torch.pybullet_goldens {record,check,both} [--fixture PATH] [--cpu]

The counterpart of ``scripts/pybullet_goldens.py``, with its commands, flags,
printed lines and exit code, plus ``--cpu``: ``record`` runs PyBullet (it
needs ``pybullet``) and writes the fixture; ``check`` replays a fixture's
actions through ``eval.pybullet_parity.torch_trajectory`` (K1 at N = 1 on the
card) and prints the JSON report, then ``PARITY PASS``, or ``PARITY FAIL`` on
standard error with exit code 1. The fixture format is the JAX package's, so
one fixture serves both. The check runs on CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    from tvc_ai_torch.eval import pybullet_parity as pp
    from tvc_ai_torch.utils.devices import add_device_flags, device_from_flags, resolve_device

    parser = argparse.ArgumentParser(description="PyBullet parity gate (PyTorch/CUDA port)")
    parser.add_argument("command", choices=["record", "check", "both"])
    parser.add_argument(
        "--fixture", default=str(pp.DEFAULT_FIXTURE), help="fixture .npz path"
    )
    add_device_flags(parser, device_flag=False)
    args = parser.parse_args(argv)

    checking = args.command in ("check", "both")
    dev = resolve_device(device_from_flags(parser, args)) if checking else None
    if args.command in ("record", "both"):
        path = pp.record_goldens(args.fixture)
        print(f"recorded {len(pp.SCENARIOS)} golden scenarios -> {path}")
    if checking:
        report = pp.check_goldens(args.fixture, device=dev)
        print(json.dumps(report, indent=2))
        if not report["passed"]:
            print("PARITY FAIL", file=sys.stderr)
            return 1
        print("PARITY PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
