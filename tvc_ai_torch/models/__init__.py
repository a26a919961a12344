"""Policy networks, twin critics, the tanh-Gaussian head and the analytic safety layer."""
