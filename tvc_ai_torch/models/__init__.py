"""Policy networks, the tanh-Gaussian head and the analytic safety layer."""
