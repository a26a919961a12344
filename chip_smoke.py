#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tvc_ai_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py [--against DIR ...]

It builds the hand-written kernel (K1, ``tvc_ai_torch/csrc/step_kernel.cu``)
from the sources, holds it against its plain PyTorch version on the card,
holds the port on the card against the port on the CPU, drives the env path
(4096 envs, full domain randomization and sensor noise, random actions) and
the slice's main path (``training.loop.collect``: a seeded 256x256
``GaussianActor`` with the safety layer flying 4096 envs), checks through
the launch counter that both went through K1, profiles the main path once
with ``torch.profiler`` (device busy time and idle share of a step, and the
kernels that take the most device time), and times K1 with CUDA events.

Phase [6] reads: K1 as built (envs per block, registers, local memory per
thread); K1's device time at 4096 envs beside its plain version, its bound
and roofline share; its decomposition: the launch floor (an empty kernel on
K1's grid), the memory floor (K1's staged I/O without its arithmetic), the
wrench part alone (substeps = 0) and the host's microseconds per
``step_kernel`` call; then K1 over N = 4096 to 262144 with each N's bound and
roofline share, and K1 against its plain version at the largest N: envs
clear of the ground at the flight bar, the sweep's batch (a few envs in
contact) at the contact bar. Each ``--against DIR`` (the root of another
checkout, e.g. the parent commit unpacked with ``git archive``) adds that
checkout's K1, built from its own sources, to phase [6]: held once against
the plain version, then timed in turns with this one (A B .. B A) at every
N, host cost included. It imports nothing of JAX or of ``tvc_ai_tpu``.

Output: progress lines; the card's name and power limit as nvidia-smi gives
them; a ``{"kernels": [...]}`` JSON line (with ``floor_ms`` and ``host_us``
beside the contract's keys); and, as the last line, ``{"ok": true,
"device": {...}}``. Any failure raises (exit code not 0, no result line); so
does a host without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import DeviceType, ProfilerActivity, profile

from tvc_ai_torch.agents import sac
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.types import EnvParams, RandomizationConfig, obs_dim
from tvc_ai_torch.ops import step_kernel as k1
from tvc_ai_torch.physics import integrator
from tvc_ai_torch.physics.integrator import ThrustControl
from tvc_ai_torch.physics.types import RigidBodyState, RocketParams
from tvc_ai_torch.training.loop import StepDraws, collect
from tvc_ai_torch.utils.devices import set_parity_precision

N_ENVS = 4096
ENV_STEPS_PER_CALL, ENV_TIMED_CALLS = 256, 8   # the shape of bench.py
ROLLOUT_STEPS = 128
PROFILE_STEPS = 32
SWEEP = (4096, 16384, 65536, 262144)   # K1's N sweep in phase [6]
HOST_RUNS = 21   # rounds of A B .. B A for the host's cost of a K1 call
HIDDEN = (256, 256)
SEED = 0
FLIGHT = dict(atol=2e-5, rtol=2e-4)    # K1 vs plain, as tests/test_pallas_step.py
CONTACT = dict(atol=5e-5, rtol=5e-4)
OBS = dict(atol=5e-5, rtol=5e-4)       # card vs CPU, as the env parity tests
REWARD = dict(atol=1e-3, rtol=1e-3)
# H100 SXM published peaks (NVIDIA data sheet): HBM rate, fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def k1_bound(state, ctrl, dr, substeps: int):
    """K1's least time on the card for this batch: each input read once and
    each output written once over the HBM rate, against its arithmetic
    (``flops_per_env``) over the fp32 rate. Returns (bound ms, what bounds
    it, bytes, bytes ms, operations ms)."""
    body = (state.pos, state.quat, state.vel, state.omega)
    n_bytes = sum(t.numel() * t.element_size() for t in (*body, *ctrl, *dr, *body))
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    flops_ms = k1.flops_per_env(substeps) * state.pos.shape[0] / FP32_FLOPS_PER_S * 1e3
    bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
    return max(bytes_ms, flops_ms), bound_by, n_bytes, bytes_ms, flops_ms


def host_us(fn, reps: int = 9, inner: int = 20) -> float:
    """Median host time of one ``fn()`` call in microseconds (the enqueue).

    Each repetition starts from an idle stream and ends in a synchronise
    outside the timed region, so the device never pushes back on the host.
    """
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter() - t0) / inner * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(fn, reps: int = 60, inner: int = 20) -> float:
    """Median device time of one ``fn()`` call, by CUDA events.

    Before each repetition the stream is held busy with ``torch.cuda._sleep``
    long enough for the host to enqueue all ``inner`` calls, so the events
    time the calls back to back on the card and not the host's launch rate.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # calibrate _sleep's cycles per millisecond
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(10_000_000)
    e.record()
    torch.cuda.synchronize()
    cycles = int(10_000_000 / s.elapsed_time(e) * (2.0 * host_ms + 1.0))
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / inner for s, e in times)


def in_turns(builds: dict, measure) -> dict:
    """``measure(wrapper)`` for each build of K1 in turns, A B .. B A (A A
    for one build): two readings each, by name."""
    order = list(builds)
    out = {name: [] for name in order}
    for name in order + order[::-1]:
        out[name].append(measure(builds[name]))
    return out


def load_k1(root: Path):
    """The K1 wrapper module of the checkout at ``root``; it builds the
    kernel from that checkout's source into that checkout's build directory."""
    spec = importlib.util.spec_from_file_location(
        f"k1_of_{abs(hash(str(root)))}", root / "tvc_ai_torch" / "ops" / "step_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def random_physics_batch(n: int, gen: torch.Generator, dev, ground: bool = False,
                         clear: bool = False):
    """Random states, controls and domain draws (the test_pallas_step recipe).

    The flight recipe starts 0.3-10 m up, so a few envs touch the ground;
    ``clear`` starts them 1-10 m up, where neither end (0.5 m from the
    centre) can reach it within a step.
    """
    def u(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    quat = torch.randn((n, 4), generator=gen, device=dev)
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    pos = u(n, 3, lo=-2.0, hi=2.0)
    pos[:, 2] = u(n, lo=1.0 if clear else 0.3, hi=0.55 if ground else 10.0)
    state = RigidBodyState(
        pos=pos.contiguous(), quat=quat,
        vel=torch.randn((n, 3), generator=gen, device=dev) * 2.0,
        omega=torch.randn((n, 3), generator=gen, device=dev),
    )
    if ground:
        ctrl = ThrustControl(torch.zeros(n, 2, device=dev),
                             torch.zeros(n, dtype=torch.bool, device=dev))
    else:
        ctrl = ThrustControl(u(n, 2, lo=-0.3, hi=0.3), u(n, lo=0.0, hi=1.0) > 0.3)
    dr = (
        u(n, lo=1.5, hi=2.5),
        u(n, lo=0.8, hi=1.2),
        torch.randn((n, 3), generator=gen, device=dev) * 0.02,
        torch.randn((n, 3), generator=gen, device=dev),
    )
    return state, ctrl, dr


def max_abs_diff(a: RigidBodyState, b: RigidBodyState) -> float:
    return max(float((getattr(a, f) - getattr(b, f)).abs().max())
               for f in ("pos", "quat", "vel", "omega"))


def assert_body_close(a: RigidBodyState, b: RigidBodyState, tol: dict, what: str) -> None:
    for f in ("pos", "quat", "vel", "omega"):
        torch.testing.assert_close(getattr(a, f), getattr(b, f), msg=f"{what} {f}", **tol)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[], type=Path, metavar="DIR",
                    help="root of another checkout whose K1 phase [6] times in turns with this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    dev = torch.device("cuda", 0)
    set_parity_precision()
    smi = nvidia_smi_line()
    log(f"[1] nvidia-smi: {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    # ---- 2. build K1 from the checkout's sources
    t0 = time.perf_counter()
    lib, build_log = k1.build()
    log(f"[2] built {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in build_log.strip().splitlines():
        log(f"[2] nvcc: {line.strip()}")

    # ---- 3. K1 against its plain version on the card
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = RocketParams()
    errs = []
    for n, ground, tol in ((N_ENVS, False, FLIGHT), (N_ENVS + 3, False, FLIGHT),
                           (N_ENVS, True, CONTACT)):
        state, ctrl, dr = random_physics_batch(n, gen, dev, ground)
        out = k1.step_kernel(state, ctrl, params, *dr)
        ref = integrator.step(state, ctrl, params, *dr)
        torch.cuda.synchronize()
        what = f"K1 n={n}{' contact' if ground else ''}"
        assert_body_close(out, ref, tol, what)
        errs.append(max_abs_diff(out, ref))
        log(f"[3] {what}: max |K1 - plain| = {errs[-1]:.3e} (atol {tol['atol']}, "
            f"rtol {tol['rtol']}) ok")
    # thrust_offset is a kernel parameter: a non-default value agrees too
    shifted = RocketParams(thrust_offset=(0.01, -0.02, -0.4))
    state, ctrl, dr = random_physics_batch(N_ENVS, gen, dev)
    assert_body_close(k1.step_kernel(state, ctrl, shifted, *dr),
                      integrator.step(state, ctrl, shifted, *dr), FLIGHT, "K1 thrust_offset")
    torch.cuda.synchronize()
    log("[3] K1 with a non-default thrust_offset: ok")

    env_params = EnvParams(
        randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True)
    )
    n_obs = obs_dim(env_params)

    # ---- 3b. the port on the card (K1) against the port on the CPU (plain
    # version), same reset, actor weights and draws, 16 steps with autoresets
    small, steps = 256, 16
    short = EnvParams(randomization=env_params.randomization, max_episode_steps=8)
    cpu_gen = torch.Generator().manual_seed(SEED + 1)
    reset_draws = rocket_env.draw_reset(short, small, torch.device("cpu"), cpu_gen)
    draws = [
        StepDraws(
            n_act=torch.randn((small, 2), generator=cpu_gen),
            n_imu=torch.randn((small, 7), generator=cpu_gen),
            reset=rocket_env.draw_reset(short, small, torch.device("cpu"), cpu_gen),
        )
        for _ in range(steps)
    ]
    runs = {}
    for where in ("cpu", "cuda"):
        to = lambda t: None if t is None else t.to(where)  # noqa: E731
        rd = rocket_env.ResetDraws(**{k: to(v) for k, v in vars(reset_draws).items()})
        dd = [StepDraws(to(d.n_act), to(d.n_imu),
                        rocket_env.ResetDraws(**{k: to(v) for k, v in vars(d.reset).items()}))
              for d in draws]
        states, obs = rocket_env.reset(short, small, device=where, draws=rd)
        actor = sac.make_actor(n_obs, 2, sac.SACConfig(HIDDEN), device=where, seed=SEED)
        runs[where] = collect(actor, states, obs, short, steps, draws=dd)
    torch.cuda.synchronize()
    a, b = runs["cuda"], runs["cpu"]
    torch.testing.assert_close(a.reward.cpu(), b.reward, **REWARD)
    torch.testing.assert_close(a.obs.cpu(), b.obs, **OBS)
    assert torch.equal(a.terminated.cpu(), b.terminated), "terminated differs card vs CPU"
    assert torch.equal(a.truncated.cpu(), b.truncated), "truncated differs card vs CPU"
    n_done = int((b.terminated | b.truncated).sum())
    assert n_done >= small, "no autoreset fired in the card-vs-CPU check"
    log(f"[3b] collect {small} envs x {steps} steps, card (K1) vs CPU (plain): "
        f"max |d obs| {float((a.obs.cpu() - b.obs).abs().max()):.3e}, "
        f"max |d reward| {float((a.reward.cpu() - b.reward).abs().max()):.3e}, "
        f"terminated/truncated equal, {n_done} episode ends: ok")

    # ---- 4. env path: batched_step_autoreset, N envs, random actions
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    states, obs = rocket_env.reset(env_params, N_ENVS, device=dev, generator=gen)

    def env_call(states):
        for _ in range(ENV_STEPS_PER_CALL):
            actions = torch.rand((N_ENVS, 2), generator=gen, device=dev) * 2.0 - 1.0
            states, out, _ = rocket_env.batched_step_autoreset(
                states, actions, env_params, generator=gen
            )
        return states, out

    states, out = env_call(states)  # warm-up
    torch.cuda.synchronize()
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    for _ in range(ENV_TIMED_CALLS):
        states, out = env_call(states)
    torch.cuda.synchronize()
    env_s = time.perf_counter() - t0
    env_launches = k1.step_kernel.launches
    env_steps = ENV_STEPS_PER_CALL * ENV_TIMED_CALLS
    assert env_launches == env_steps, (env_launches, env_steps)
    assert bool(torch.isfinite(out.obs).all() and torch.isfinite(out.reward).all())
    env_rate = N_ENVS * env_steps / env_s
    log(f"[4] env path: {N_ENVS} envs x {env_steps} steps in {env_s:.3f} s = "
        f"{env_rate:.1f} env steps/s ({env_s / env_steps * 1e3:.3f} ms per step); "
        f"K1 launches {env_launches} == steps taken")

    # ---- 5. the slice's main path: collect with the 256x256 actor + safety
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    actor = sac.make_actor(n_obs, 2, sac.SACConfig(HIDDEN), device=dev, seed=SEED)
    states, obs = rocket_env.reset(env_params, N_ENVS, device=dev, generator=gen)
    warm = collect(actor, states, obs, env_params, 8, generator=gen)
    states, obs = warm.states, warm.obs
    torch.cuda.synchronize()
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    ro = collect(actor, states, obs, env_params, ROLLOUT_STEPS, generator=gen)
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    main_launches = k1.step_kernel.launches
    assert main_launches == ROLLOUT_STEPS, (main_launches, ROLLOUT_STEPS)
    assert ro.obs.shape == (N_ENVS, n_obs) and ro.reward.shape == (ROLLOUT_STEPS, N_ENVS)
    finite = bool(torch.isfinite(ro.obs).all() and torch.isfinite(ro.reward).all()
                  and all(torch.isfinite(getattr(ro.states.body, f)).all()
                          for f in ("pos", "quat", "vel", "omega")))
    assert finite, "non-finite values in the rollout"
    roll_rate = N_ENVS * ROLLOUT_STEPS / roll_s
    log(f"[5] collect: {N_ENVS} envs x {ROLLOUT_STEPS} steps in {roll_s:.3f} s = "
        f"{roll_rate:.1f} env steps/s ({roll_s / ROLLOUT_STEPS * 1e3:.3f} ms per step); "
        f"mean reward {float(ro.reward.mean()):.4f}; terminations "
        f"{int(ro.terminated.sum())}; autoresets {int((ro.terminated | ro.truncated).sum())}; "
        f"all finite {finite}; K1 launches {main_launches}")

    # ---- 5b. the same path under torch.profiler: the step time and the
    # device's busy time (union of its kernel and copy intervals) of one run
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        collect(actor, ro.states, ro.obs, env_params, PROFILE_STEPS, generator=gen)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) / PROFILE_STEPS * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy_us, reach = 0.0, float("-inf")
    for start, end, _ in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy_us / 1e3 / PROFILE_STEPS
    by_name: dict[str, list[float]] = {}
    for start, end, name in spans:
        by_name.setdefault(name, []).append((end - start) / 1e3)
    log(f"[5b] profiled collect, {N_ENVS} envs x {PROFILE_STEPS} steps: step {prof_ms:.4f} ms "
        f"on the host clock; device busy {busy_ms:.4f} ms per step, idle "
        f"{1.0 - busy_ms / prof_ms:.2%} of the step; {len(spans) / PROFILE_STEPS:.1f} "
        f"device operations per step; K1 "
        f"{sum(sum(d) for n, d in by_name.items() if 'step_kernel' in n) / PROFILE_STEPS:.5f} "
        f"ms per step")
    for name, durs in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:15]:
        log(f"[5b] {sum(durs) / PROFILE_STEPS:9.5f} ms/step {len(durs) / PROFILE_STEPS:6.1f}x "
            f"{name[:90]}")
    # the trace's ~1e5 event objects would make every later garbage collection
    # slow, and with it the host time [6] measures
    del prof, spans, by_name
    gc.collect()

    # ---- 6. K1 at N envs beside its launch floor (an empty kernel on its
    # grid), its memory floor (its I/O with no arithmetic), its wrench part
    # (substeps = 0), the host's cost of a call, its plain version and its
    # bound; then the same kernel over a sweep of N. Each --against build
    # is timed in turns with this one.
    attrs = k1.kernel_attributes()
    log(f"[6] K1 as built: {attrs['block']} envs per block, {attrs['registers']} registers, "
        f"{attrs['local_bytes']} B of local memory per thread (stack frame + spills)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    state, ctrl, dr = random_physics_batch(N_ENVS, gen, dev)
    wrench_only = dataclasses.replace(params, substeps=0)
    builds = {"this": k1}
    ref = integrator.step(state, ctrl, params, *dr)
    for root in args.against:
        other = builds[str(root)] = load_k1(root)
        for line in other.build()[1].strip().splitlines():
            if "registers" in line or "stack frame" in line:
                log(f"[6] against {root}: nvcc: {line.strip()}")
        assert_body_close(other.step_kernel(state, ctrl, params, *dr), ref, FLIGHT,
                          f"K1 of {root}")
        log(f"[6] against {root}: K1 n={N_ENVS} within the flight bar: ok")

    ms = in_turns(builds, lambda b: device_ms(lambda: b.step_kernel(state, ctrl, params, *dr)))
    floor_ms = device_ms(lambda: k1.launch_floor(N_ENVS, dev))
    copy_ms = device_ms(lambda: k1.copy_floor(state, ctrl, *dr))
    wrench = in_turns(builds,
                      lambda b: device_ms(lambda: b.step_kernel(state, ctrl, wrench_only, *dr)))
    plain_ms = device_ms(lambda: integrator.step(state, ctrl, params, *dr), inner=2)
    host = {name: [] for name in builds}
    for _ in range(HOST_RUNS):
        turn = in_turns(builds, lambda b: host_us(
            lambda: b.step_kernel(state, ctrl, params, *dr), reps=1))
        for name, readings in turn.items():
            host[name] += readings
    host = {name: statistics.median(readings) for name, readings in host.items()}
    (kernel_ms, kernel_ms_again), wrench_ms, call_us = ms["this"], wrench["this"][0], host["this"]
    bound_ms, bound_by, n_bytes, bytes_ms, flops_ms = k1_bound(state, ctrl, dr, params.substeps)
    log(f"[6] K1 at {N_ENVS} envs: {kernel_ms:.5f} ms, again {kernel_ms_again:.5f} ms; plain "
        f"version {plain_ms:.5f} ms; bound {bound_ms:.6f} ms ({n_bytes} B -> "
        f"{bytes_ms:.6f} ms, {k1.flops_per_env(params.substeps) * N_ENVS} FLOP -> "
        f"{flops_ms:.6f} ms), roofline share {bound_ms / kernel_ms:.2%}; no single PyTorch "
        f"call computes this step")
    log(f"[6] K1 decomposition at {N_ENVS} envs: launch floor {floor_ms:.5f} ms (K1 is "
        f"{kernel_ms / floor_ms:.2f}x it); memory floor {copy_ms:.5f} ms; wrench only "
        f"(substeps = 0) {wrench_ms:.5f} ms; host {call_us:.2f} us per step_kernel call")
    for name in builds:
        if name != "this":
            log(f"[6] against {name}: K1 at {N_ENVS} envs {ms[name][0]:.6f}, "
                f"{ms[name][1]:.6f} ms (this {kernel_ms:.6f}, {kernel_ms_again:.6f}); wrench "
                f"only {wrench[name][0]:.6f}, {wrench[name][1]:.6f} ms (this "
                f"{wrench['this'][0]:.6f}, {wrench['this'][1]:.6f}); host {host[name]:.2f} us "
                f"per call (this {call_us:.2f})")
    for n in SWEEP:
        s_n, c_n, d_n = random_physics_batch(n, gen, dev)
        ms_n = in_turns(builds, lambda b: device_ms(lambda: b.step_kernel(s_n, c_n, params, *d_n)))
        b_ms, b_by, b_bytes, _, _ = k1_bound(s_n, c_n, d_n, params.substeps)
        for name, (first, second) in ms_n.items():
            log(f"[6] sweep n={n}{'' if name == 'this' else f' against {name}'}: {first:.5f}, "
                f"{second:.5f} ms; bound {b_ms:.6f} ms ({b_by}, {b_bytes} B), roofline share "
                f"{b_ms / first:.2%}")
    # the largest N of the sweep against the plain version: the sweep's batch
    # (a few envs touch the ground) at the contact bar, envs clear of the
    # ground at the flight bar
    n = SWEEP[-1]
    for batch, tol, what in (((s_n, c_n, d_n), CONTACT, "some envs in contact"),
                             (random_physics_batch(n, gen, dev, clear=True), FLIGHT,
                              "clear of the ground")):
        out = k1.step_kernel(batch[0], batch[1], params, *batch[2])
        ref = integrator.step(batch[0], batch[1], params, *batch[2])
        torch.cuda.synchronize()
        assert_body_close(out, ref, tol, f"K1 n={n} {what}")
        errs.append(max_abs_diff(out, ref))
        log(f"[6] K1 n={n} {what}: max |K1 - plain| = {errs[-1]:.3e} "
            f"(atol {tol['atol']}, rtol {tol['rtol']}) ok")

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "K1 step_kernel",
        "route": "cuda",
        "source": "tvc_ai_torch/csrc/step_kernel.cu",
        "replaces": "tvc_ai_tpu/ops/pallas_step.py:73",
        "launches": main_launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "floor_ms": floor_ms,
        "host_us": call_us,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
