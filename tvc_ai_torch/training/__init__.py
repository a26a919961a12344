"""The fused SAC train iteration and the act-only rollout."""
