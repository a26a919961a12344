"""The reference's performance suite on the port.

    python -m tvc_ai_torch.benchmark [--out PATH] [--cpu]

The counterpart of ``tests/benchmark.py``: the same five functions, the same
result keys and the same printed lines. Each function takes its sizes as
keyword arguments whose defaults are the reference's:

- env steps/s: one env stepped 1,000 times with random actions (never
  reset, as in the reference), then 4096 envs x 128 steps with autoreset,
  one warm-up call and 4 timed calls;
- inference/s: 2,000 one-row calls of the SAC actor, deterministic and
  stochastic, then 100 calls at 4,096 rows;
- SAC gradient steps/s: 500 ``sac.update``s at batch 256, obs 10, action 2;
- host RSS with a 1,000,000-row replay (only where psutil imports, as in
  the reference), and the CUDA allocator's bytes in use;
- a 20-iteration fused SAC run (256 envs x 32 steps, 4 updates a step) and
  the iteration where its reward settles (``convergence_iteration``).

Every env step goes through ``rocket_env.batched_step`` or
``batched_step_autoreset``, so on the card the physics is K1, the single env
at N = 1. Times are host wall clock with ``torch.cuda.synchronize`` where
the reference calls ``block_until_ready``; a warm-up call (the counterpart
of the reference's compile call, which on the card also builds K1 and
initialises cuBLAS) stays out of each timed window. Random draws come from
a ``torch.Generator`` on the device. Runs on CUDA unless ``--cpu`` is
given; writes ``benchmark_results.json`` to ``tvc_ai_torch/build/`` unless
``--out`` names another path.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from tvc_ai_torch.agents import replay as replay_mod
from tvc_ai_torch.agents import sac as sac_mod
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.types import EnvParams
from tvc_ai_torch.ops.step_kernel import BUILD_DIR
from tvc_ai_torch.training import loop as loop_mod
from tvc_ai_torch.utils.devices import (
    DEFAULT_DEVICE,
    add_device_flags,
    device_from_flags,
    resolve_device,
)

DEFAULT_OUT = BUILD_DIR / "benchmark_results.json"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _uniform(shape: tuple, gen: torch.Generator) -> torch.Tensor:
    """U[-1, 1) on the generator's device."""
    return torch.rand(shape, generator=gen, device=gen.device) * 2.0 - 1.0


def single_env_steps(results: dict, dev: torch.device, steps: int) -> None:
    """One env at N = 1, never reset, random actions: env_steps_per_sec_single."""
    params = EnvParams()
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = rocket_env.reset(params, 1, dev, generator=gen)
    gen = torch.Generator(device=dev).manual_seed(1)
    state, out = rocket_env.batched_step(state, torch.zeros((1, 2), device=dev), params,
                                         generator=gen)   # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, out = rocket_env.batched_step(state, _uniform((1, 2), gen), params,
                                             generator=gen)
    _sync(dev)
    results["env_steps_per_sec_single"] = steps / (time.perf_counter() - t0)


def batched_env_steps(results: dict, dev: torch.device, num_envs: int, steps: int,
                      calls: int) -> None:
    """``num_envs`` envs with autoreset, ``steps`` steps a call:
    env_steps_per_sec_batched4096."""
    params = EnvParams()
    gen = torch.Generator(device=dev).manual_seed(2)
    states, _ = rocket_env.reset(params, num_envs, dev, generator=gen)
    gen = torch.Generator(device=dev).manual_seed(3)

    def run(states):
        rewards = []
        for _ in range(steps):
            states, out, _ = rocket_env.batched_step_autoreset(
                states, _uniform((num_envs, 2), gen), params, generator=gen)
            rewards.append(out.reward)
        return states, torch.stack(rewards).mean()

    states, r = run(states)   # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        states, r = run(states)
    _sync(dev)
    results["env_steps_per_sec_batched4096"] = num_envs * steps * calls / (
        time.perf_counter() - t0)


def bench_env_steps(results: dict, device: str | torch.device = DEFAULT_DEVICE, *,
                    single_steps: int = 1000, num_envs: int = 4096, steps: int = 128,
                    calls: int = 4) -> None:
    dev = resolve_device(device)
    single_env_steps(results, dev, single_steps)
    batched_env_steps(results, dev, num_envs, steps, calls)


def bench_inference(results: dict, device: str | torch.device = DEFAULT_DEVICE, *,
                    calls: int = 2000, batch: int = 4096, batch_calls: int = 100) -> None:
    dev = resolve_device(device)
    agent = sac_mod.init(10, 2, sac_mod.SACConfig(), dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, det in (("deterministic", True), ("stochastic", False)):
        obs1 = torch.zeros((1, 10), device=dev)
        a = sac_mod.select_action(agent.actor, obs1, deterministic=det, generator=gen)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            a = sac_mod.select_action(agent.actor, obs1, deterministic=det, generator=gen)
        _sync(dev)
        results[f"inference_per_sec_{name}"] = calls / (time.perf_counter() - t0)

    obs_b = torch.zeros((batch, 10), device=dev)
    a = sac_mod.select_action(agent.actor, obs_b, deterministic=True)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(batch_calls):
        a = sac_mod.select_action(agent.actor, obs_b, deterministic=True)
    _sync(dev)
    results["inference_per_sec_batched4096"] = batch * batch_calls / (time.perf_counter() - t0)


def bench_training(results: dict, device: str | torch.device = DEFAULT_DEVICE, *,
                   updates: int = 500, batch_size: int = 256) -> None:
    dev = resolve_device(device)
    cfg = sac_mod.SACConfig(batch_size=batch_size)
    agent = sac_mod.init(10, 2, cfg, dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {
        "obs": torch.randn((batch_size, 10), generator=gen, device=dev),
        "action": _uniform((batch_size, 2), gen),
        "reward": torch.randn((batch_size,), generator=gen, device=dev),
        "next_obs": torch.randn((batch_size, 10), generator=gen, device=dev),
        "done": torch.zeros(batch_size, device=dev),
    }
    agent, m = sac_mod.update(agent, batch, cfg, generator=gen)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(updates):
        agent, m = sac_mod.update(agent, batch, cfg, generator=gen)
    _sync(dev)
    results["train_steps_per_sec"] = updates / (time.perf_counter() - t0)


def bench_memory(results: dict, device: str | torch.device = DEFAULT_DEVICE, *,
                 rows: int = 1_000_000) -> None:
    dev = resolve_device(device)
    try:
        import psutil
    except ImportError:
        return
    proc = psutil.Process()
    results["memory_rss_mb_baseline"] = proc.memory_info().rss / 1e6
    example = {
        "obs": torch.zeros(10), "action": torch.zeros(2), "reward": torch.zeros(()),
        "next_obs": torch.zeros(10), "done": torch.zeros(()),
    }
    buf = replay_mod.ReplayBuffer.create(rows, example, dev)
    _sync(dev)
    results["memory_rss_mb_with_buffer"] = proc.memory_info().rss / 1e6
    if dev.type == "cuda":
        results["hbm_bytes_in_use"] = int(torch.cuda.memory_allocated(dev))


def convergence_iteration(rewards: list[float]) -> int:
    """The first index from 3 on whose reward is within 1 % of the mean of
    the 3 before it (a zero mean never matches); ``len(rewards)`` if none."""
    for i in range(3, len(rewards)):
        prev = np.mean(rewards[i - 3:i])
        if prev != 0 and abs(rewards[i] - prev) / abs(prev) < 0.01:
            return i
    return len(rewards)


def bench_convergence(results: dict, device: str | torch.device = DEFAULT_DEVICE, *,
                      iterations: int = 20, num_envs: int = 256, rollout_steps: int = 32,
                      updates_per_step: int = 4, hidden_dims: tuple[int, ...] = (64, 64),
                      batch_size: int = 256, buffer_size: int = 262144,
                      learning_starts: int = 2048) -> None:
    """A short fused run; the iteration where its reward settles."""
    dev = resolve_device(device)
    sac_cfg = sac_mod.SACConfig(hidden_dims=hidden_dims, batch_size=batch_size,
                                buffer_size=buffer_size, learning_starts=learning_starts)
    loop_cfg = loop_mod.TrainLoopConfig(num_envs=num_envs, rollout_steps=rollout_steps,
                                        updates_per_step=updates_per_step)
    carry = loop_mod.init_carry(EnvParams(), sac_cfg, loop_cfg, dev, seed=0)
    it = loop_mod.make_train_iteration(sac_cfg, loop_cfg)
    rewards = []
    t0 = time.perf_counter()
    for _ in range(iterations):
        carry, m = it(carry, EnvParams())
        rewards.append(float(m["reward_mean"]))
    results["convergence_wallclock_sec"] = time.perf_counter() - t0
    results["convergence_rewards"] = rewards
    results["convergence_iteration"] = convergence_iteration(rewards)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="Performance suite (PyTorch/CUDA port)")
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT,
                        help=f"results JSON (default {DEFAULT_OUT})")
    add_device_flags(parser, device_flag=False)
    args = parser.parse_args(argv)
    dev = resolve_device(device_from_flags(parser, args))

    results: dict = {"timestamp": time.strftime("%Y-%m-%d %H:%M:%S")}
    for name, fn in [
        ("env", bench_env_steps),
        ("inference", bench_inference),
        ("training", bench_training),
        ("memory", bench_memory),
        ("convergence", bench_convergence),
    ]:
        print(f"benchmarking {name}...", flush=True)
        fn(results, dev)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=2))
    for k, v in results.items():
        if isinstance(v, float):
            print(f"{k}: {v:,.1f}")
    print(f"results -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
