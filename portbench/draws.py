"""Every random number a run consumes, made on the device from the seed.

Each chunk of steps has its own generator state, seeded from (seed, chunk),
so the draws of any chunk can be made again after the window for the
reference. The calls and shapes are those the port makes when it draws for
itself (``rocket_env.draw_reset``, ``_step_draws``, the actor's noise); the
benchmark hands them to the program through its ``draws=`` parameters.
"""

from __future__ import annotations

import hashlib

import torch

RESET = -1  # the chunk index of the set-up's first reset


def chunk_seed(seed: int, chunk: int) -> int:
    digest = hashlib.sha256(f"portbench:{seed}:{chunk}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def uniform(shape, gen, device) -> torch.Tensor:
    """U[-1, 1) of ``shape``."""
    return torch.rand(shape, device=device, generator=gen) * 2.0 - 1.0


def reset_draws(p, n: int, gen: torch.Generator, device) -> dict:
    """What a reset of n envs reads: the pose, the domain draw (or the
    feasible-only candidates) and the first observation's IMU noise."""
    r = p.randomization
    d = {"u_init": uniform((n, 7), gen, device)}
    if r.needs_uniform:
        d["u_dr"] = uniform((n, 7), gen, device)
    if r.enabled and not r.feasible_only:
        d["n_dr"] = torch.randn((n, 3), device=device, generator=gen)
    if r.sensor_noise_enabled:
        d["n_imu"] = torch.randn((n, 7), device=device, generator=gen)
    if r.enabled and r.feasible_only:
        k = r.feasible_tries
        d["u_feas"] = uniform((n, k, 4), gen, device)
        d["n_feas"] = torch.randn((n, k, 3), device=device, generator=gen)
    return d


def step_draws(p, n: int, gen: torch.Generator, device, act) -> dict:
    """One step's draws: the action's (``act(n, gen)``, the entry's: the
    policy's exploration noise or a uniform action), the new observation's
    IMU noise and dropout draw, and the autoreset's draws."""
    r = p.randomization
    d = act(n, gen)
    if r.sensor_noise_enabled:
        d["n_imu"] = torch.randn((n, 7), device=device, generator=gen)
    if r.sensor_dropout_enabled:
        d["u_drop"] = torch.rand((n,), device=device, generator=gen)
    d["reset"] = reset_draws(p, n, gen, device)
    return d


def for_chunk(p, n: int, seed: int, chunk: int, steps: int, act, gen: torch.Generator,
              device):
    """The draws of one chunk, step by step (a generator: each step's draws
    are made when the caller asks for them)."""
    gen.manual_seed(chunk_seed(seed, chunk))
    for _ in range(steps):
        yield step_draws(p, n, gen, device, act)


def first_reset(p, n: int, seed: int, gen: torch.Generator, device) -> dict:
    gen.manual_seed(chunk_seed(seed, RESET))
    return reset_draws(p, n, gen, device)


def rows(d, index: torch.Tensor):
    """The draws of the envs ``index`` (nested dicts of tensors)."""
    return {k: rows(v, index) if isinstance(v, dict) else v.index_select(0, index)
            for k, v in d.items()}


def weights(p, seed: int, device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The actor's weights from the seed, in one draw on the device:
    [(W, b)] for each hidden layer, the mean head and the log-std head, W of
    shape (out, in) at the scale of an orthogonal init of gain sqrt(2)."""
    widths = (p.obs_dim, *p.hidden_dims)
    shapes = list(zip(widths[1:], widths)) + [(2, widths[-1]), (2, widths[-1])]
    gen = torch.Generator(device=device)
    gen.manual_seed(chunk_seed(seed, -2))
    flat = torch.randn(sum(o * i + o for o, i in shapes), device=device, generator=gen)
    out, at = [], 0
    for o, i in shapes:
        w = flat[at:at + o * i].view(o, i) * (2.0 / max(o, i)) ** 0.5
        at += o * i
        b = flat[at:at + o] * 0.05
        at += o
        out.append((w.contiguous(), b.contiguous()))
    return out
