"""Learning agents (the act half of SAC so far)."""
