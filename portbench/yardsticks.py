"""The benchmark's frozen yardsticks: the card's peaks and the work a step
needs, computed from shapes.

These functions are the benchmark's own and do not follow the program: a
later kernel is judged against the same work. ``k1_bytes_per_env`` and
``k1_flops_per_env`` are frozen copies of the step kernel's I/O list and
operation count (``tvc_ai_torch/ops/step_kernel.py``: ``INPUTS``,
``OUTPUT_WIDTHS``, ``flops_per_env``).
"""

from __future__ import annotations

# NVIDIA H100 SXM, published dense peaks at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

F32, I32, BOOL = 4, 4, 1
ACTION_DIM = 2
REWARD_TERMS = 10  # the reward's nine weighted terms and its anti-hacking term


def k1_bytes_per_env() -> int:
    """K1's least traffic per env: 23 float inputs (pos, quat, vel, omega,
    gimbal, mass, thrust scale, cg offset, wind) and one bool (thrust on)
    read once, 13 floats (pos, quat, vel, omega) written once: 145 B."""
    return (3 + 4 + 3 + 3 + 2 + 1 + 1 + 3 + 3) * F32 + BOOL + (3 + 4 + 3 + 3) * F32


def k1_flops_per_env(substeps: int) -> int:
    """K1's arithmetic per env and control step, as the algorithm counts it."""
    return 143 + 298 * substeps


def env_state_bytes(p) -> int:
    """One env's ``EnvState``: body 13, fuel, step count, phase, success flag
    and count, previous action 2, its flag, the reward window and its length,
    trim 4, the domain draw 10, and the held IMU reading 7 with dropout."""
    floats = 13 + 1 + ACTION_DIM + p.reward.variance_window + 4 + 10
    if p.randomization.sensor_dropout_enabled:
        floats += 7
    ints = 4  # step count, phase, success count, reward window length
    return floats * F32 + ints * I32 + 2 * BOOL


def draws_bytes(p) -> int:
    """One env's random numbers for one step: the new observation's IMU noise
    and dropout draw, and the autoreset's full reset draw (pose, domain or the
    feasible-only candidates, the first observation's IMU noise)."""
    r = p.randomization
    n = 0
    if r.sensor_noise_enabled:
        n += 7 + 7
    if r.sensor_dropout_enabled:
        n += 1
    n += 7  # pose
    if r.needs_uniform:
        n += 7
    if r.enabled and r.feasible_only:
        n += r.feasible_tries * (4 + 3)
    elif r.enabled:
        n += 3
    return n * F32


def step_output_bytes(p) -> int:
    """One env's ``StepOutput`` (observation, reward, four diagnostics,
    phase, four flags, the reward's terms) and its next policy observation."""
    return (2 * p.obs_dim + 1 + 4 + REWARD_TERMS) * F32 + I32 + 4 * BOOL


def env_step_bytes_per_env(p) -> int:
    """The least bytes one env's step needs: its state read and written once,
    the action and the step's draws read once, the output written once."""
    return 2 * env_state_bytes(p) + ACTION_DIM * F32 + draws_bytes(p) + step_output_bytes(p)


def actor_flops_per_row(p) -> int:
    """The SAC actor's forward pass: 2 x sum of in x out over its hidden
    layers and its mean and log-std heads."""
    widths = (p.obs_dim, *p.hidden_dims)
    hidden = sum(a * b for a, b in zip(widths, widths[1:]))
    return 2 * (hidden + 2 * widths[-1] * ACTION_DIM)
