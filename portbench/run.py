"""Run one cell of the benchmark on one card and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero, with no result, without a CUDA card (or with fewer cards than
the cell asks for), or when JAX, flax or the JAX package was loaded into the
process. The numbers the check compared are printed last on standard error,
each beside its limit, and again under ``checks``, the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / ".portbench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
# compiled bytecode too: where the host keeps none (PYTHONDONTWRITEBYTECODE, a
# read-only site-packages), every run would compile torch's modules from source
sys.pycache_prefix = str(CACHE / "pycache")
sys.dont_write_bytecode = False
FORBIDDEN = ("jax", "jaxlib", "flax", "tvc_ai_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    t_torch = time.perf_counter()
    from portbench import harness

    chips = harness.load_cell(args.workload)["cell"]["chips"]
    t_harness = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    t_cards = time.perf_counter()
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), device,
                         T_START)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result["device"]["kind"] = torch.cuda.get_device_name(device)
    # the first part of set-up by step: import torch, import the harness and
    # read the cell, find the cards
    result["run"]["before_harness"] = [t_torch - T_START, t_harness - t_torch,
                                       t_cards - t_harness]
    checks = result.pop("checks")
    result["context"] = {"power": power_limit(),
                         "float32_matmul_precision": torch.get_float32_matmul_precision(),
                         "allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
