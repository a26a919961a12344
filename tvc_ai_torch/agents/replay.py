"""Device-resident ring replay buffer.

Counterpart of ``tvc_ai_tpu/agents/replay.py``: a dict of fixed-size device
tensors ``(capacity, *feature)``, written a batch at a time at the ring
pointer and sampled uniformly from the valid region.

``ptr`` and ``size`` are host Python ints: they depend only on how many rows
were added, so the ring arithmetic and the caller's ``learning_starts`` gate
need no device synchronisation. ``add_batch`` writes the rows in place (the
counterpart of the reference donating the buffer) and returns the buffer with
its new ``ptr`` and ``size``; the returned buffer shares ``data`` with the
one passed in.
"""

from __future__ import annotations

import dataclasses

import torch

from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class ReplayBuffer:
    data: dict[str, torch.Tensor]   # name -> (capacity, *feature)
    ptr: int                        # next write index
    size: int                       # valid rows (saturates at capacity)
    capacity: int

    @staticmethod
    def create(
        capacity: int,
        example: dict[str, torch.Tensor],
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> "ReplayBuffer":
        """Allocate zeros from one example transition (no batch axis)."""
        dev = resolve_device(device)
        data = {
            k: torch.zeros((capacity, *v.shape), dtype=v.dtype, device=dev)
            for k, v in example.items()
        }
        return ReplayBuffer(data=data, ptr=0, size=0, capacity=capacity)


def add_batch(buf: ReplayBuffer, batch: dict[str, torch.Tensor]) -> ReplayBuffer:
    """Write a batch of B transitions at the ring pointer.

    The capacity must be a multiple of B, so a batch never straddles the
    wrap point and each field is one contiguous copy.
    """
    b = next(iter(batch.values())).shape[0]
    if buf.capacity % b != 0:
        raise ValueError(f"replay capacity {buf.capacity} must be a multiple of batch {b}")
    for k, v in batch.items():
        buf.data[k][buf.ptr:buf.ptr + b].copy_(v)
    return dataclasses.replace(
        buf, ptr=(buf.ptr + b) % buf.capacity, size=min(buf.size + b, buf.capacity)
    )


def sample(
    buf: ReplayBuffer,
    batch_size: int,
    idx: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> dict[str, torch.Tensor]:
    """Rows ``idx`` (B,) int64 of every field; without ``idx``, a uniform draw
    from [0, max(size, 1)) taken from ``generator``."""
    some = next(iter(buf.data.values()))
    if idx is None:
        idx = torch.randint(0, max(buf.size, 1), (batch_size,), device=some.device,
                            generator=generator)
    elif idx.shape != (batch_size,):
        raise ValueError(f"idx has shape {tuple(idx.shape)}, want ({batch_size},)")
    return {k: v.index_select(0, idx) for k, v in buf.data.items()}
