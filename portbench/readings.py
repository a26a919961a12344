"""Read the numbers a cell's limits are set from, in one process on the card.

    python3 -m portbench.readings --workload <cell> --seeds 12 --control-seeds 3

Runs the cell as ``portbench.run`` does (set-up, a window of ``--seconds``,
the check) once for each of ``--seeds`` seeds with the program, then once for
each of ``--control-seeds`` seeds with the control in the program's place:
the reference one precision lower (floats in bfloat16, the actor's products
in TF32), at the cell's own size and load. Prints one JSON line per run, then
the program's largest and the control's smallest reading of each number.
The limits in ``limits/<cell>.json`` are set between the two.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=4_000_000_000)
    ap.add_argument("--seconds", type=float, default=None,
                    help="window per run (default: run_seconds of BENCHMARK.json)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.readings: no CUDA card", file=sys.stderr)
        return 2
    seconds = args.seconds or json.loads((harness.ROOT / "BENCHMARK.json").read_text())[
        "run_seconds"]
    device = torch.device("cuda", 0)
    worst: dict[str, dict[str, float]] = {"program": {}, "control": {}}
    plan = ([("program", args.first_seed + i) for i in range(args.seeds)]
            + [("control", args.first_seed + 1000 + i) for i in range(args.control_seeds)])
    for system, seed in plan:
        r = harness.run(args.workload, seed, seconds, False, device, time.perf_counter(),
                        system=system)
        numbers = r["run"]["numbers"]
        print(json.dumps({"workload": args.workload, "system": system, "seed": seed,
                          "correct": r["correct"], "numbers": numbers,
                          "gap_max_at": r["run"]["gap_max_at"],
                          "metrics": {k: m["value"] for k, m in r["metrics"].items()},
                          "chunks": r["run"]["chunks"]}), flush=True)
        pick = max if system == "program" else min
        for k, v in numbers.items():
            worst[system][k] = pick(worst[system].get(k, v), v)
        del r
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "program_max": worst["program"],
                      "control_min": worst["control"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
