"""Render training plots from a run directory (CSV or TensorBoard events).

    python -m tvc_ai_torch.visualize --log-dir RUN [--output-dir RUN/plots]

The counterpart of ``scripts/visualize.py``, with its flags and printed
lines (one artifact path a line): ``viz.visualize.create_plots`` over the
run's ``metrics.csv`` or ``tb/`` events. Rendering needs matplotlib; where
it does not import, the command says so on standard error and exits 1. It
touches no device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="TVC visualization (PyTorch/CUDA port)")
    parser.add_argument("--log-dir", type=str, required=True)
    parser.add_argument("--output-dir", type=str, default=None)
    args = parser.parse_args(argv)

    from tvc_ai_torch.viz.visualize import create_plots

    out = args.output_dir or str(Path(args.log_dir) / "plots")
    try:
        artifacts = create_plots(args.log_dir, out)
    except ModuleNotFoundError as exc:
        if exc.name != "matplotlib":
            raise
        print(f"matplotlib does not import here ({exc}); no plots rendered", file=sys.stderr)
        return 1
    for a in artifacts:
        print(a)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
