"""Device resolution: explicit, CUDA by default, no silent CPU fallback.

Counterpart of ``tvc_ai_tpu/utils/devices.py``. Every entry point of the port
takes ``device=`` (default ``"cuda"``) and passes it through
``resolve_device``, which raises when CUDA is asked for and absent. The CPU is
used only when the caller names it (the parity tests do).

``DeviceManager`` and ``get_device_manager`` keep the reference's surface
over a ``torch.device``: ``"auto"`` is the card (raising without one),
``to_device`` / ``to_numpy`` map over nested dicts, lists, tuples and
dataclasses, ``get_memory_info`` reads the CUDA allocator.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import Any, Callable

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"
logger = logging.getLogger(__name__)


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


def _map(fn: Callable[[Any], Any], x: Any) -> Any:
    """``fn`` over every array or tensor leaf of nested dicts, lists, tuples
    (named ones too) and dataclasses; other leaves stay as they are."""
    if isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
        return fn(x)
    if isinstance(x, dict):
        return type(x)((k, _map(fn, v)) for k, v in x.items())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map(fn, v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_map(fn, v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: _map(fn, getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    return x


class DeviceManager:
    """The reference's device surface over one ``torch.device``: ``"auto"``
    (or None) is the card, any other value goes to ``resolve_device``."""

    def __init__(self, device: str | torch.device | None = "auto"):
        self.requested = device
        self.device = resolve_device(DEFAULT_DEVICE if device in ("auto", None) else device)
        self.platform = self.device.type
        logger.info("DeviceManager: using %s (%s)", self.device, self.platform)

    @property
    def is_tpu(self) -> bool:
        """Kept for the reference's callers: never a TPU here."""
        return False

    def to_device(self, x: Any) -> Any:
        """Host arrays or tensors (nested) -> tensors on the managed device."""
        return _map(lambda a: torch.as_tensor(a).to(self.device), x)

    def to_numpy(self, x: Any) -> Any:
        """Tensors (nested) -> host numpy arrays (waits for the device)."""
        return _map(lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
                    else np.asarray(a), x)

    def synchronize(self) -> None:
        """Wait for the card's outstanding work (nothing to wait for on the CPU)."""
        if self.platform == "cuda":
            torch.cuda.synchronize(self.device)

    def get_memory_info(self) -> dict[str, float]:
        """The CUDA allocator's bytes in use, the card's total and the peak in
        use; the host's RAM share in use where psutil imports."""
        stats: dict[str, float] = {}
        if self.platform == "cuda":
            stats = {
                "bytes_in_use": float(torch.cuda.memory_allocated(self.device)),
                "bytes_limit": float(torch.cuda.mem_get_info(self.device)[1]),
                "peak_bytes_in_use": float(torch.cuda.max_memory_allocated(self.device)),
            }
        try:
            import psutil
        except ImportError:
            return stats
        stats["host_ram_used_frac"] = psutil.virtual_memory().percent / 100.0
        return stats

    def device_count(self, platform: str | None = None) -> int:
        """Devices of ``platform`` (default: the managed one's)."""
        if (platform or self.platform) == "cuda":
            return torch.cuda.device_count()
        return 1


_GLOBAL: DeviceManager | None = None


def get_device_manager(device: str | torch.device = "auto") -> DeviceManager:
    """The process's ``DeviceManager``, made anew when a device other than
    ``"auto"`` and other than the current one's request is named."""
    global _GLOBAL
    if _GLOBAL is None or (device != "auto" and _GLOBAL.requested != device):
        _GLOBAL = DeviceManager(device)
    return _GLOBAL
