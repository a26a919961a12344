"""Training-log plots."""
