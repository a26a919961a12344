"""Device resolution: explicit, CUDA by default, no silent CPU fallback.

Counterpart of ``tvc_ai_tpu/utils/devices.py``. Every entry point of the port
takes ``device=`` (default ``"cuda"``) and passes it through
``resolve_device``, which raises when CUDA is asked for and absent. The CPU is
used only when the caller names it (the parity tests do).
"""

from __future__ import annotations

import argparse

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` for ``device``; raises if it is CUDA and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


def add_device_flags(parser: argparse.ArgumentParser, device_flag: bool = True) -> None:
    """The reference's ``--cpu`` and, with ``device_flag``, ``--device``
    (CUDA by default), of which ``--cpu`` is the synonym for ``--device cpu``."""
    if device_flag:
        parser.add_argument("--device", type=str, default=None,
                            help=f"{DEFAULT_DEVICE} (default) or cpu")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")


def device_from_flags(parser: argparse.ArgumentParser, args: argparse.Namespace) -> str:
    """The device ``add_device_flags``'s flags name; ``--cpu`` beside another
    ``--device`` is an argparse error."""
    device = getattr(args, "device", None)
    if args.cpu and device not in (None, "cpu"):
        parser.error(f"--cpu conflicts with --device {device}")
    return "cpu" if args.cpu else (device or DEFAULT_DEVICE)


def set_parity_precision() -> None:
    """Full-float32 matmuls and convolutions (TF32 off), for parity runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
