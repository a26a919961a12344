"""Data-parallel training over ``torch.distributed`` (one process per device)."""
