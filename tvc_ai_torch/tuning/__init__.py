"""Hyperparameter search: the SAC study and its objective."""
