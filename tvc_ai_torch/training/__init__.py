"""Rollout collection (the act-and-simulate half of the fused SAC iteration)."""
