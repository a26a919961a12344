"""Learning agents: SAC with its replay ring and optimizers."""
