#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``tvc_ai_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py [--against DIR ...]

It builds the hand-written kernel (K1, ``tvc_ai_torch/csrc/step_kernel.cu``)
from the sources, holds it against its plain PyTorch version on the card,
holds the port on the card against the port on the CPU, drives the env path
(4096 envs, full domain randomization and sensor noise, random actions),
the rollout path (``training.loop.collect``: a seeded 256x256
``GaussianActor`` with the safety layer flying 4096 envs) and the main path,
the fused SAC train iteration (``training.loop.make_train_iteration`` at the
default configuration: 4096 envs, 128 steps, a 256x256 actor and twin
critics, batch 256, a replay of ~1M rows), checks through the launch counter
that each went through K1, profiles the rollout and the train iteration
with ``torch.profiler`` (device busy time and idle share of a step, and the
kernels that take the most device time), and times K1, one SAC update and
one replay write + sample with CUDA events.

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

Phase [7] holds the learner on the card against the port on the CPU (256
envs, 16 steps with updates, the same draws and initial state); phase [8]
runs the train iteration at full width (one warm-up, two timed iterations,
one more under ``torch.cuda.set_sync_debug_mode("error")``, which fails on
any host-device synchronisation) and prints train env steps/s with learning
on; phase [8b] profiles 16 steps of it and times one ``sac.update`` and one
replay ``add_batch`` + ``sample`` (device ms by CUDA events, host ms per
call).

Phases [9a], [9] and [9b] drive the trainer's entry points, read from the
port's own ``config/default.yaml``. [9a] holds the evaluation rollout
(``eval.rollout.make_eval_fn``, 20 episodes, the default training env) on
the card against the CPU over 64 steps, times and profiles the eval step at
N = 20, counts how many outcomes differ over the full 1000-step horizon, and
holds K1 against its plain version at N = 1 (in flight and in contact), 2, 20
and 50 beside its launch floor there. [9] runs ``training.trainer.Trainer`` at the default
configuration for 2 iterations of 4096 envs x 128 steps with an eval round
after each (per-stage seconds from its ``StageTimer``, train env steps/s,
eval metrics, checkpoint bytes and save seconds), resumes from its final
checkpoint into a 3rd iteration with the restored carry and generators
checked bit for bit, and resumes once from a best step directory. [9b] runs
the three evaluation suites (``eval.evaluate.run_all_suites``) at their full
episode counts and horizons. The launch counter shows one K1 launch per
env step of training and per step an eval ran.

Phases [10], [10b] and [10c] drive the PPO+SAC+TD3 ensemble. [10] holds one
``agents.ensemble.make_ensemble_iteration`` per acting member (ppo, sac,
td3 and the performance-weighted blend) and the stand-alone
``ppo.make_train_iteration`` on the card against the CPU: 64 envs x 16
steps at the default widths, the learning gate open from the fourth step,
the same draws, PPO over 4 epochs; then the ppo-acting iteration at PPO's
default 10 epochs, with the minibatch rows whose clip decision differs card
vs CPU counted and PPO's parameters held at 1e-4 where none did, else within
a bound from its learning rate and the updates since the first. [10b] runs
``EnsembleTrainer`` on ``config/default.yaml`` with
``training.algorithm=ensemble`` (4096 envs x 128 steps): one iteration with
each actor forced (PPO's GAE and epochs timed alone, and one PPO
update at 65,536 rows by CUDA events), each member's eval stage, a
profiled voting window, one iteration through ``train()`` with its save and
a bit-equal resume from ``ensemble_final.pt``, then
``tvc_ai_torch.train.main`` for ``training.algorithm`` ppo and td3. [10c]
trains ``config/ensemble_r4.yaml`` (512 envs, SAC batch 1024, 16 SAC + 16
TD3 updates per step) with ``rollout_steps`` cut from 128 to 16 for two
iterations.

Phases [11a], [11b] and [11c] drive the robust-training env options
(feasible-only draws, the easy/hard mixture, sensor dropout, actuator delay,
the survival-normalized payout, equilibrium-relative shaping). [11a] holds
``batched_step_autoreset`` with every option on against the CPU (256 envs x
32 steps of 8-step episodes, the same draws) and prints the shares of resets
that took the nominal fallback or were gated to the nominal plant, and of
dropped readings. [11b] trains ``config/robust_full_r4d.yaml`` at its widths
(512 envs, SAC batch 1024, 16 updates per step) with ``rollout_steps`` cut
from 128 to 16 for two iterations and its final eval (nominal, robust,
stage), times the env step with the options on against the same step with
them off in turns, and profiles 4 learning steps; [11c] resumes it bit for
bit.

Phases [12a], [12b] and [12c] drive the SAC learner's extensions. [12a]
holds ten ``sac.update``s at batch 256 with ``transformer_r3.yaml``'s
transformer actor (d_model 128, 8 heads, 2 layers, an EMA actor) and one act
at 512 on the card against the CPU. [12b] trains ``transformer_r3.yaml`` at
its widths (512 envs, history 4, 16 updates of batch 1024 per step) with
``rollout_steps`` cut from 128 to 16 for two iterations and its final eval,
resumes it bit for bit, profiles two learning steps and times one
``sac.update`` at batch 1024. [12c] holds one train iteration with ICM, the
physics-informed loss, RND and hierarchical RL on (256 envs x 8 steps) on the
card against the CPU, trains the default config with the four on for one
32-step iteration with its hierarchical eval and a bit-equal resume, and
times the env step with the extensions on against off, in turns.

Phases [13a], [13b] and [13c] drive the export path and the rest of the
learners. [13a] loads [9]'s trained default actor (256x256, obs 10) with
``eval.evaluate.load_agent_state``, collects the calibration observations
through K1 (64 envs, DR and noise off, card against CPU on the same draws),
quantizes the actor to ``.tvcq`` (the bytes from the card's weights equal a
CPU copy's), builds ``native/tvc_micro.cpp`` with g++ into
``tvc_ai_torch/build/``, holds the int8 actions against the card's float
deterministic actor within the export budget (max |d a| 0.1, else it fails),
writes the C array, its header and the TFLM example, and checks that
``native/`` is unchanged. [13b] holds one population iteration (3 agents x 16
envs x 8 steps) and ``clone_winners`` card against CPU, then runs
``PopulationConfig``'s defaults (4 agents x 128 envs x 64 steps, the default
SAC widths) for two iterations, a clone and a profiled population learning
step. [13c] holds ``SafetyCorrectionNet`` and ``correction_loss``'s gradient
at 4096 rows card against CPU and times a forward + backward. The TFLite
route of the export needs TensorFlow, which the card's host lacks; the
script does not run it.

Phases [14a] and [14b] drive data-parallel training (``parallel.mesh``).
[14a] spawns two gloo ranks on the card (both on cuda:0) and two on the CPU,
each pair one group, and runs ``make_sharded_train`` for one 16-step
iteration (256 envs, 128 a rank, 8-step episodes: updates, resets and ring
writes all fire) and ``make_sharded_ensemble_train`` with sac and with ppo
acting, every rank on its own draws, the same on both sides: each rank's
parameters card vs CPU at 1e-4, its env shard, replay and counters at the
env bars, and on each side the replicas bit for bit equal across the ranks;
it prints each card rank's K1 launches. [14b] runs one default-config
iteration (4096 envs x 128 steps, 256x256, batch 256, after a 16-step
warm-up) three ways in turns: unsharded, ``make_sharded_train`` at world 1
on NCCL in this process, and at world 2 on gloo with both ranks on cuda:0
(2048 envs each); it prints s per iteration, env steps/s, all-reduces per
update and the time of one all-reduce of the critic's gradient, then runs
``torchrun --standalone --nproc-per-node 1 -m tvc_ai_torch.train`` for one
32-step iteration and fails on a non-zero exit. [14c] runs [14a]'s sharded
runs and [14b]'s iteration at world 2 on NCCL, rank r on cuda:r, where the
host has two GPUs (held against [14a]'s gloo ranks); on a one-GPU host it
says that NCCL at world 2 is not checked. Phases [15a] and [15b] drive LQR
demonstration seeding (``training.demos``): [15a] times ``design_lqr`` on the
host CPU and holds ``generate_demonstrations`` (64 envs x 32 steps in
``robust_r4.yaml``'s demo env) through K1 against the CPU on the same
draws; [15b] trains ``robust_r4.yaml`` at its widths (512 envs, demo seeding
of 512 envs x 600 steps, a 25 % demo fraction, BC 2.5) with
``rollout_steps`` cut from 128 to 16 for two iterations and prints the demo
seeding's seconds and success rate, the replay and demo-buffer sizes, s per
iteration, updates/s and K1 launches.

Phases [16a]-[16e] drive the distillation chain. [16a] designs the
gain-scheduled LQR (``design_lqr_schedule``, 7 x 7 cells of
``dagger_distill``'s widened DR box) with its verification (1,568 rows x
600 steps) on the card, timed, and on the CPU on the same draws: flipped
rollouts counted and bounded, the selected variants and gains equal where
decided. [16b] holds ``cem.refine_per_draw`` card vs CPU (64 draws x 8 pop x
160 steps x 2 generations: every draw's win equal, parted draws counted and
their scores bounded) and times one refinement at 512 draws x 32 pop x
500 steps, generations cut to 2. [16c] holds both DAgger iterations card vs
CPU (64 envs x 16 steps, 32 minibatches), runs the scheduled teacher at the
CLI's full width (512 x 512 steps, history 8, a 2,097,152-row ring, 1,500
minibatches of 4,096), the CEM teacher at 512 draws x 32 pop with its depth
cut, writes ``student.pt`` and runs ``python -m tvc_ai_torch.dagger_distill``
for one cut iteration. [16d] holds ``theta_hat_action`` and one θ-DAgger
iteration card vs CPU, runs one at 512 draws x 64 pop with its depth cut and
evaluates the θ policy on 512 robustness episodes. [16e] trains
``robust_student_ft_r5.yaml`` at its widths warm-started from [16c]'s
``student.pt`` (two 16-step iterations), holds the pilot card vs CPU (8
episodes x 32 particles x 16 steps) and runs ``python -m
tvc_ai_torch.pilot_eval`` at 512 episodes x 192 particles for 64 steps with
one library selection.

Phases [17a]-[17c] drive the single-env surface, where every step is K1 at
N = 1. [17a] flies ``RocketTVCEnv`` (sensor noise on, seeded actions, DR off
so it climbs clear of the ground) for consecutive episodes of 1,000 steps in
all, each from its own reset draws, and ``EnhancedRocketTVCEnv`` (curiosity on, its ICM carried across;
sensor noise on, zero actions) for one episode of up to 1,000 steps, on the
card and on the CPU from the same reset and IMU draws (obs 5e-5 / 5e-4,
reward 1e-3, flags and lengths exact), through the gym classes where
gymnasium imports and through their gymnasium-free bases
(``env.single.RocketTVC`` / ``EnhancedRocketTVC``, the same reset and step)
where it does not, and prints ms per step, device-to-host reads per step and
K1 launches. [17b] runs ``tests/test_integration.py``'s mini training on the
card (``RocketTVCEnv`` + ``agents.legacy.SACAgent`` 32x32, 3 episodes x 60
steps). [17c] runs the six research diagnostics through ``main([...])`` at a
cut depth: ``lqr_balance`` and ``scripted_controller`` at one CG offset
against the same call with ``--cpu`` (exit codes and result lines equal,
verbose lines within 0.02, the step where they part printed),
``inspect_policy`` and ``diagnose_cg`` on [9]'s trained actor,
``policy_breakdown`` on [16c]'s ``student.pt`` and ``ablate_dr`` on [9]'s
checkpoint at 64 episodes and a 128-step horizon (patched into the env
parameters they build where they have no flag for it).

Phases [18a]-[18d] drive the last modules. [18a] flies the five
PyBullet-parity scenarios through ``eval.pybullet_parity.torch_trajectory``
(K1 at N = 1, 210 launches) against the same on the CPU at the observation
bar, then runs ``python -m tvc_ai_torch.pybullet_goldens check`` on a fixture
written from the CPU trajectories. [18b] runs ``python -m
tvc_ai_torch.tune_hyperparameters`` at its defaults' width (256 envs, 50,000
steps a trial, 8 eval episodes) with the trials cut from 20 to 3, whose
parameters must equal the CPU's draws of the same seed. [18c] holds the
reference's remaining names card vs CPU (the quaternion extras at 1e-6,
``ppo.select_action`` at 1e-5, an 8-step iteration with a constant
``act_fn`` at [7]'s bars) and reads ``DeviceManager("cuda")``'s memory.
[18d] loads [9]'s ``metrics.csv`` and plots it where matplotlib imports.

Phases [19a] and [19b] drive the last two options. [19a] holds
``compute_dtype="bfloat16"`` at width 32 card vs CPU (the forward passes, one
``sac.update`` by its parameter deltas, a 16-step iteration of 256 envs, at
the bf16 bars of ``BF16_FWD``, ``BF16_DELTA``, ``BF16_OBS`` and
``BF16_METRICS``), then times the default configuration in float32 and in
bfloat16 in turns (a 128-step iteration of 4096 envs, one ``sac.update``'s
device and host ms and device operations) and ``robust_full_r4d.yaml``'s
learning step (16 updates of batch 1024). [19b] holds
``hoist_bookkeeping=True`` at K = 4 (256 envs x 16 steps, learning on) card
vs CPU at [7]'s bars and against the per-step cadence on the card on the same
draws with the updates gated off (1e-6), then times the default
configuration with ``update_interval`` 4 and a 999,424-row replay, per-step
cadence and hoisted in turns, and profiles one chunk of each.

Phase [20] reads the JAX package's flax msgpack files
(``tests/fixtures/jax_msgpack/``, written by the JAX package) through the
port's entry points: the default-width legacy ``SACAgent.save`` file
(``SACAgent.load`` and ``eval.evaluate.load_agent_state``), a DAgger student
(``load_agent_state``), a θ-student (``policy_breakdown.load_policy``) and an
ensemble checkpoint (``MultiAlgorithmAgent.load_checkpoint``), holds each
one's outputs on 64 fixed observations against the JAX package's
(``expected.npz``) at 1e-5 and prints the decoder's host ms per MB; then it
runs the three suites (``run_all_suites`` at its defaults) on the legacy
policy and a default-config ``Trainer`` warm-started from the student for
one 2-step iteration, both through K1.

Phase [21] reads the JAX trainer's orbax checkpoint
(``tests/fixtures/jax_orbax/``: a default-config JAX ``Trainer`` after one
2-step iteration, written by the JAX package) with the port's own zstd, OCDBT
and zarr reader (``utils.orbax_read``): it decodes the agent, then the whole
carry (the 999,424-row replay ring included) on the host and prints the MB,
ms and MB/s of each, holds every carry leaf's SHA-256 against the fixture's
``manifest.json``, and holds the actions and twin Q of
``load_agent_state(<step dir>)`` against the JAX package's (``expected.npz``)
at 1e-5; then it runs the three suites on that agent and a default-config
``Trainer`` resumed from the checkpoint for one 2-step iteration, both
through K1, and prints the K1 launches of each.

Phase [22] reads the JAX trainer's checkpoint written by two devices
(``tests/fixtures/jax_orbax_mesh2/``: the same configuration at
``hardware.mesh_devices=2``), decodes it (ms) with every leaf's SHA-256
held; resumes it at world 2, two gloo ranks on the one card, each rank's
env rows, replay shard, counters and episode ring held against its shard's
SHA-256s before training; resumes it at world 1 with the replay re-laid in
global step blocks (held against the explicit permutation of the decoded
rows); and trains each resume one 2-step iteration with its eval round
through K1, printing the launches of each rank and the phase's seconds.

Output: progress lines; the card's name and power limit as nvidia-smi gives
them; a ``{"kernels": [...]}`` JSON line (with ``floor_ms``, ``host_us``,
K1's time and launch floor at N = 1, 2, 20, 50, the eval step's ms and the
launches of each path, the ensemble's included, beside the contract's keys;
``launches`` is the trainer's, [9]); and, as the last line, ``{"ok": true,
"device": {...}}``. Any failure raises (exit code not 0, no result line); so
does a host without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import DeviceType, ProfilerActivity, profile

from tvc_ai_torch.agents import ensemble, ppo, replay, sac, td3
from tvc_ai_torch.config import (
    build_env_params,
    build_loop_config,
    build_sac_config,
    default_config_path,
    load_config,
)
from tvc_ai_torch.env import randomization, rocket_env
from tvc_ai_torch.env.types import EnvParams, RandomizationConfig, obs_dim
from tvc_ai_torch.env.single import RocketConfig
from tvc_ai_torch.eval.evaluate import _suite_env_params, load_agent_state, run_all_suites
from tvc_ai_torch import dagger_distill, pilot_eval, pybullet_goldens, tune_hyperparameters
from tvc_ai_torch.eval import pybullet_parity
from tvc_ai_torch.eval.rollout import (
    EvalDraws,
    make_eval_fn,
    make_policy_eval_fn,
    steps_run,
    summarize_stats,
)
from tvc_ai_torch.export.c_array import generate_c_array, generate_tflm_example
from tvc_ai_torch.export.micro import MicroActor, build_runtime, export_micro, quantize_actor
from tvc_ai_torch.export.tflite import (
    CalibrationDraws,
    benchmark_latency,
    calibration_shape,
    collect_representative_obs,
)
from tvc_ai_torch.models import hierarchical as hier_mod
from tvc_ai_torch.models.safety import (
    SafetyConstraints,
    SafetyCorrectionNet,
    correction_loss,
    violations,
)
from tvc_ai_torch.models.transformer import TransformerActor
from tvc_ai_torch.ops import step_kernel as k1
from tvc_ai_torch.physics import integrator, quaternion
from tvc_ai_torch.physics.integrator import ThrustControl
from tvc_ai_torch.physics.types import RigidBodyState, RocketParams
from tvc_ai_torch.parallel import mesh
from tvc_ai_torch.training import cem, dagger, demos, loop, pilot, theta_student
from tvc_ai_torch.tuning import hpo
from tvc_ai_torch.training.loop import IterDraws, SampleDraws, StepDraws, collect
from tvc_ai_torch.train import main as train_main
from tvc_ai_torch.training.population import (
    PopulationConfig,
    clone_winners,
    init_population,
    make_population_iteration,
    population_returns,
)
from tvc_ai_torch.training.trainer import Trainer, demo_env_params
from tvc_ai_torch.training.trainer_ensemble import FINAL_CHECKPOINT, EnsembleTrainer
from tvc_ai_torch.utils.checkpoint import diff_states, flat_state
from tvc_ai_torch.utils.devices import DeviceManager, set_parity_precision
from tvc_ai_torch.viz import visualize as viz

ROOT = Path(__file__).resolve().parent
N_ENVS = 4096
ENV_STEPS_PER_CALL, ENV_TIMED_CALLS = 256, 2   # bench.py's call shape, 2 calls
ROLLOUT_STEPS = 128
PROFILE_STEPS = 32
TRAIN_PROFILE_STEPS = 16
EVAL_TIMED_STEPS = 256
# the default training run, config/default.yaml:29-46 (algorithms.sac) and
# :189-197 (training), as [7] and [8] build it by hand; [9] reads the YAML
DEFAULT_SAC = dict(hidden_dims=(256, 256), lr_actor=5e-5, lr_critic=1.5e-4, lr_alpha=3e-4,
                   buffer_size=1_000_000, learning_starts=1000, batch_size=256, tau=0.005,
                   gamma=0.99, gradient_clip_norm=5.0, reward_scale=0.05)  # ent_coef: auto
DEFAULT_LOOP = dict(num_envs=4096, rollout_steps=128, updates_per_step=1, update_interval=1,
                    use_safety_layer=True)
PARAMS = dict(atol=1e-4, rtol=0.0)     # learner card vs CPU: every parameter after 16 steps
METRICS = dict(atol=1e-5, rtol=1e-3)   # the iteration's mean metrics (atol for those near 0)
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


PHASE_STARTS: list[tuple[str, float]] = []


def phase(name: str) -> None:
    """Mark the start of phase ``name`` (its seconds are printed at the end)."""
    PHASE_STARTS.append((name, time.perf_counter()))


def phase_seconds() -> str:
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter()]
    return ", ".join(f"{name} {end - start:.1f}"
                     for (name, start), end in zip(PHASE_STARTS, ends))


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


def device_breakdown(prof, steps: int, step_ms: float, tag: str, what: str,
                     top: int = 15) -> dict:
    """From a ``torch.profiler`` run of ``steps`` steps: the device's busy
    time per step (the union of its kernel and copy intervals), its idle
    share of ``step_ms``, device operations per step, K1's device time and
    the ``top`` kernels that take the most device time, logged under ``tag``.
    Returns the device milliseconds per step by kernel name, with the busy
    time under ``"busy"`` and the operations per step under ``"ops"``."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy_us, reach = 0.0, float("-inf")
    for start, end, _ in spans:
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy_us / 1e3 / steps
    by_name: dict[str, list[float]] = {}
    for start, end, name in spans:
        by_name.setdefault(name, []).append((end - start) / 1e3)
    log(f"{tag} {what}: step {step_ms:.4f} ms on the host clock; device busy {busy_ms:.4f} ms "
        f"per step, idle {1.0 - busy_ms / step_ms:.2%} of the step; {len(spans) / steps:.1f} "
        f"device operations per step; K1 "
        f"{sum(sum(d) for n, d in by_name.items() if 'step_kernel' in n) / steps:.5f} "
        f"ms per step")
    for name, durs in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:top]:
        log(f"{tag} {sum(durs) / steps:9.5f} ms/step {len(durs) / steps:6.1f}x {name[:90]}")
    return {**{name: sum(durs) / steps for name, durs in by_name.items()},
            "busy": busy_ms, "ops": len(spans) / steps}


def learner_draws(params: EnvParams, n: int, steps: int, sac_cfg: sac.SACConfig,
                  gen: torch.Generator) -> tuple[rocket_env.ResetDraws, list[IterDraws]]:
    """CPU draws of a train iteration of n envs over ``steps`` steps from an
    empty replay: the first reset's, then each step's (action and IMU noise,
    the autoreset's) and, once the replay holds ``learning_starts`` rows,
    one update's (rows, noise)."""
    cpu = torch.device("cpu")
    reset_draws = rocket_env.draw_reset(params, n, cpu, gen)
    iter_draws = []
    for t in range(steps):
        size = (t + 1) * n
        iter_draws.append(IterDraws(
            step=StepDraws(
                n_act=torch.randn((n, 2), generator=gen),
                n_imu=torch.randn((n, 7), generator=gen),
                reset=rocket_env.draw_reset(params, n, cpu, gen),
            ),
            samples=[SampleDraws(
                idx=torch.randint(0, size, (sac_cfg.batch_size,), generator=gen),
                update=sac.UpdateDraws(
                    n_next=torch.randn((sac_cfg.batch_size, 2), generator=gen),
                    n_pi=torch.randn((sac_cfg.batch_size, 2), generator=gen),
                ),
            )] if size >= sac_cfg.learning_starts else [],
        ))
    return reset_draws, iter_draws


def to_device(d, where):
    """A copy of draws (a dataclass of tensors, nested, or None) on ``where``."""
    if d is None:
        return None
    if isinstance(d, torch.Tensor):
        return d.to(where)
    if isinstance(d, (list, tuple)):
        return [to_device(x, where) for x in d]
    return type(d)(**{f.name: to_device(getattr(d, f.name), where)
                      for f in dataclasses.fields(d)})


def max_abs_diff(a: RigidBodyState, b: RigidBodyState) -> float:
    return max(float((getattr(a, f) - getattr(b, f)).abs().max())
               for f in ("pos", "quat", "vel", "omega"))


def assert_body_close(a: RigidBodyState, b: RigidBodyState, tol: dict, what: str) -> None:
    for f in ("pos", "quat", "vel", "omega"):
        torch.testing.assert_close(getattr(a, f), getattr(b, f), msg=f"{what} {f}", **tol)


TRAINER_TOTAL = 1_048_576   # 2 iterations of 4096 envs x 128 steps
RESUME_TOTAL = 1_572_864    # one more


def counting_evals(trainer, record: list) -> None:
    """Wrap the trainer's eval function so each call records (K1 launches,
    steps run, host seconds)."""
    inner = trainer._eval_fn

    def counted(agent, generator, params, draws=None):
        before, t0 = k1.step_kernel.launches, time.perf_counter()
        stats = inner(agent, generator, params, draws)
        record.append((k1.step_kernel.launches - before,
                       steps_run(stats.lengths, params.max_episode_steps),
                       time.perf_counter() - t0))
        return stats

    trainer._eval_fn = counted


def dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def run_trainer(scratch: Path, dev) -> int:
    """[9]: ``Trainer`` on the default config for 2 iterations, then resumed;
    returns the first run's K1 launches."""
    cfg_path = default_config_path()
    cfg = load_config(cfg_path, [f"training.total_timesteps={TRAINER_TOTAL}"])
    t1 = Trainer(cfg, output_dir=scratch / "run1", device=dev)
    steps_per_iter = t1.loop_cfg.num_envs * t1.loop_cfg.rollout_steps
    evals: list = []
    counting_evals(t1, evals)
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    result = t1.train()
    wall = time.perf_counter() - t0
    launches = k1.step_kernel.launches
    iters = result["iterations"]
    assert iters == TRAINER_TOTAL // steps_per_iter and result["stop_reason"] == "total_timesteps", (
        iters, result["stop_reason"])
    assert result["env_steps"] == TRAINER_TOTAL, result["env_steps"]
    assert all(n == ran for n, ran, _ in evals), evals
    # nominal + stage eval after each iteration, and the final eval
    assert len(evals) == 2 * (iters + 1), len(evals)
    assert launches == iters * t1.loop_cfg.rollout_steps + sum(n for n, _, _ in evals), launches
    timing = result["stage_timing"]
    for name in ("train_iteration", "evaluate", "checkpoint"):
        log(f"[9] trainer stage {name}: {timing[name]['total_sec']:.4f} s in all, "
            f"{timing[name]['count']}x, mean {timing[name]['mean_sec']:.4f} s")
    train_rate = iters * steps_per_iter / timing["train_iteration"]["total_sec"]
    eval_steps = sum(ran for _, ran, _ in evals)
    eval_s = sum(sec for _, _, sec in evals)
    final = scratch / "run1" / "checkpoints"
    best = scratch / "run1" / "checkpoints_best"
    final_steps = sorted(int(d.name) for d in final.iterdir() if d.name.isdigit())
    best_steps = sorted(int(d.name) for d in best.iterdir() if d.name.isdigit())
    assert final_steps == [TRAINER_TOTAL] and best_steps, (final_steps, best_steps)
    ckpt_bytes = dir_bytes(final / str(TRAINER_TOTAL))
    for name in ("final_metrics.json", "curriculum.json", "metrics.csv", "training.log"):
        assert (scratch / "run1" / name).exists(), name
    metrics = {k: v for k, v in result.items() if k.startswith("eval_")}
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    log(f"[9] trainer (default config, {cfg_path.name}): {iters} iterations of "
        f"{t1.loop_cfg.num_envs} envs x {t1.loop_cfg.rollout_steps} steps in {wall:.3f} s of "
        f"train(); {train_rate:.1f} train env steps/s over the train_iteration stage, "
        f"{result['steps_per_sec']:.1f} env steps/s over the loop; stop_reason "
        f"{result['stop_reason']}; {len(evals)} eval rollouts of {cfg.training.eval_episodes} "
        f"episodes ran {eval_steps} steps in {eval_s:.3f} s ({eval_steps / eval_s:.1f} eval "
        f"steps/s); K1 launches {launches} == {iters} x {t1.loop_cfg.rollout_steps} + "
        f"{eval_steps} eval steps")
    log("[9] eval metrics: " + ", ".join(f"{k} {v:.5g}" for k, v in sorted(metrics.items())))
    log(f"[9] final checkpoint {final_steps[0]}: {ckpt_bytes} B; best steps {best_steps}; "
        f"checkpoint stage {timing['checkpoint']['count']}x, mean "
        f"{timing['checkpoint']['mean_sec']:.4f} s a save")

    # resume from the manager root (the final save_last checkpoint)
    cfg2 = load_config(cfg_path, [f"training.total_timesteps={RESUME_TOTAL}"])
    t2 = Trainer(cfg2, output_dir=scratch / "run2", resume=final, device=dev)
    diffs = diff_states({"carry": t1.carry, "generator": t1.generator},
                        {"carry": t2.carry, "generator": t2.generator})
    assert not diffs, diffs[:10]
    assert t2.env_steps == TRAINER_TOTAL and t2.iteration == iters, (t2.env_steps, t2.iteration)
    n_leaves = len(flat_state({"carry": t2.carry, "generator": t2.generator}))
    evals2: list = []
    counting_evals(t2, evals2)
    before = k1.step_kernel.launches
    result2 = t2.train()
    launches2 = k1.step_kernel.launches - before
    assert result2["env_steps"] == RESUME_TOTAL and result2["iterations"] == iters + 1, (
        result2["env_steps"], result2["iterations"])
    assert launches2 == t2.loop_cfg.rollout_steps + sum(n for n, _, _ in evals2), launches2
    # and from one best step directory
    t3 = Trainer(cfg, output_dir=scratch / "run3", resume=best / str(best_steps[-1]), device=dev)
    assert t3.env_steps == best_steps[-1], (t3.env_steps, best_steps)
    log(f"[9] resume from {final.name}/: restored carry and generators equal the first "
        f"trainer's bit for bit ({n_leaves} leaves); env_steps {TRAINER_TOTAL} -> "
        f"{result2['env_steps']} after one more iteration (K1 launches {launches2}); resume from "
        f"{best.name}/{best_steps[-1]}: env_steps {t3.env_steps}: ok")
    t3.logger.close()
    del t1, t2, t3
    gc.collect()
    return launches


def run_suites(scratch: Path, dev, n_obs: int) -> int:
    """[9b]: the three evaluation suites at full episode counts and horizons
    with a seeded 256x256 actor; returns their K1 launches."""
    suite_sac = sac.SACConfig(HIDDEN)
    agent = sac.init(n_obs, 2, suite_sac, device=dev, seed=SEED)
    out_dir = scratch / "suites"
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    results = run_all_suites(agent, suite_sac, out_dir, seed=SEED, device=dev)
    wall = time.perf_counter() - t0
    launches = k1.step_kernel.launches
    assert launches == sum(r.steps for r in results.values()), (
        launches, {k: r.steps for k, r in results.items()})
    for name, r in results.items():
        n_eps = r.stats.returns.shape[0]
        assert (out_dir / f"{name}_episodes.csv").exists(), name
        assert all(math.isfinite(v) for v in r.metrics.values()), r.metrics
        log(f"[9b] suite {name}: {n_eps} episodes, horizon "
            f"{_suite_env_params(name).max_episode_steps}, {r.steps} steps run before the early "
            f"exit in {r.seconds:.3f} s ({n_eps * r.steps / r.seconds:.1f} env steps/s, "
            f"{r.seconds / r.steps * 1e3:.3f} ms per step); success "
            f"{r.metrics['eval_success_rate']:.3f}, crash {r.metrics['eval_crash_rate']:.3f}, "
            f"mean length {r.metrics['eval_length_mean']:.1f}")
    summary = json.loads((out_dir / "evaluation_summary.json").read_text())
    assert set(summary) == set(results), summary.keys()
    log(f"[9b] run_all_suites: {wall:.3f} s; CSVs, evaluation_summary.json"
        f"{', evaluation_dashboard.png' if (out_dir / 'evaluation_dashboard.png').exists() else ''}"
        f" written; K1 launches {launches} == steps run")
    return launches


ENS_N, ENS_STEPS = 64, 16            # [10] card vs CPU
ENS_WEIGHTS = (0.2, 0.5, 0.3)        # the blend's performance weights in [10]
PPO_HELD_EPOCHS = 4                  # [10] holds PPO card vs CPU over 4 epochs x 8 minibatches
ONE_ITERATION = 4096 * 128           # env steps of one default-config iteration
CLI_STEPS = 32                       # [10b] the CLI routes' rollout_steps, cut from 128
FLAGSHIP_STEPS = 16                  # [10c] rollout_steps, cut from 128


def ensemble_draws(actor: str, cfg: ensemble.EnsembleConfig, params: EnvParams,
                   gen: torch.Generator, n: int = ENS_N, steps: int = ENS_STEPS) -> list:
    """Every draw of one [10] iteration (n envs x steps) on the CPU: the
    acting member's noise (three for the blend), the env step's, and the
    replay rows and noise of each update once the gate opens."""
    gate = max(cfg.sac.learning_starts, cfg.sac.batch_size)
    cpu = torch.device("cpu")
    out = []
    for t in range(steps):
        size = (t + 1) * n
        shape = (3, n, 2) if actor == "ensemble" else (n, 2)
        step = StepDraws(n_act=torch.randn(shape, generator=gen),
                         n_imu=torch.randn((n, 7), generator=gen),
                         reset=rocket_env.draw_reset(params, n, cpu, gen))
        learn = size >= gate
        b_sac, b_td3 = cfg.sac.batch_size, cfg.td3.batch_size
        out.append(ensemble.EnsembleStepDraws(
            step=step,
            sac=[SampleDraws(idx=torch.randint(0, size, (b_sac,), generator=gen),
                             update=sac.UpdateDraws(n_next=torch.randn((b_sac, 2), generator=gen),
                                                    n_pi=torch.randn((b_sac, 2), generator=gen)))
                 ] if learn else [],
            td3=[ensemble.TD3Draws(idx=torch.randint(0, size, (b_td3,), generator=gen),
                                   noise=torch.randn((b_td3, 2), generator=gen))
                 ] if learn else []))
    return out


MEMBER_NETS = {"sac": ("actor", "critic", "target_critic"),
               "td3": ("actor", "critic", "target_actor", "target_critic"),
               "ppo": ("actor", "value")}


def net_param_err(a: torch.nn.Module, b: torch.nn.Module, what: str, hold: bool = True) -> float:
    """Largest |card - CPU| over a module's parameters; with ``hold``, fails
    beyond PARAMS."""
    err = 0.0
    for (name, p), q in zip(a.named_parameters(), b.parameters(), strict=True):
        if hold:
            torch.testing.assert_close(p.detach().cpu(), q.detach(), **PARAMS,
                                       msg=f"{what}.{name}")
        err = max(err, float((p.detach().cpu() - q.detach()).abs().max()))
    return err


def member_param_err(a, b, hold: bool = True) -> float:
    """Largest |card - CPU| over every parameter of every member; with
    ``hold``, fails beyond PARAMS."""
    err = max(net_param_err(getattr(getattr(a, member), net), getattr(getattr(b, member), net),
                            f"{member}.{net}", hold)
              for member, names in MEMBER_NETS.items() for net in names)
    if hold:
        torch.testing.assert_close(a.sac.log_alpha.cpu(), b.sac.log_alpha, **PARAMS)
    return err


def ensemble_both(actor: str, cfg: ensemble.EnsembleConfig, short: EnvParams, seed: int):
    """One [10] iteration of ``actor`` on the card and on the CPU from the
    same initial state and draws: ((card carry, metrics), (CPU carry, metrics))."""
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(seed)
    reset_draws = rocket_env.draw_reset(short, ENS_N, cpu, gen)
    draws = ensemble_draws(actor, cfg, short, gen)
    perms = [torch.randperm(ENS_STEPS * ENS_N, generator=gen) for _ in range(cfg.ppo.n_epochs)]
    out = {}
    for where in ("cpu", "cuda"):
        carry = ensemble.init_carry(short, cfg, ENS_N, device=where, seed=SEED,
                                    reset_draws=to_device(reset_draws, where))
        it = ensemble.make_ensemble_iteration(actor, cfg, ENS_N, ENS_STEPS)
        out[where] = it(carry, ENS_WEIGHTS, short, to_device(draws, where),
                        to_device(perms, where) if actor == "ppo" else None)
    torch.cuda.synchronize()
    return out["cuda"], out["cpu"]


def hold_ensemble_rollout(a, b, am: dict, bm: dict, metrics=None) -> None:
    """An ensemble iteration's rollout card (``a``) vs CPU (``b``) at the env
    bars, and the metrics named in ``metrics`` (default: all) at METRICS."""
    torch.testing.assert_close(a.obs.cpu(), b.obs, **OBS)
    for k in ("obs", "next_obs", "action"):
        torch.testing.assert_close(a.buffer.data[k].cpu(), b.buffer.data[k], **OBS, msg=k)
    torch.testing.assert_close(a.buffer.data["reward"].cpu(), b.buffer.data["reward"], **REWARD)
    assert torch.equal(a.buffer.data["done"].cpu(), b.buffer.data["done"]), "terminated"
    for name in ("episodes", "successes", "ep_length"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), f"{name} differs"
    assert torch.equal(a.env_states.step_count.cpu(), b.env_states.step_count), "truncation"
    for k in bm if metrics is None else metrics:
        torch.testing.assert_close(am[k].cpu(), bm[k], **METRICS, msg=k)


@contextlib.contextmanager
def recording_clip_decisions(record: dict):
    """Within the block, each ``ppo.update`` first appends its minibatch's
    clip decisions (|ratio - 1| > clip_range per row, from the same forward
    the update takes) to ``record[device type]``."""
    original = ppo.update

    def recording(state, batch, cfg, axis_name=None):
        with torch.no_grad():
            mean, log_std = state.actor(batch["obs"])
            ratio = torch.exp(ppo.dist.log_prob(mean, log_std, batch["pre_tanh"])
                              - batch["log_prob"])
            record.setdefault(ratio.device.type, []).append(
                (ratio - 1.0).abs() > cfg.clip_range)
        return original(state, batch, cfg, axis_name)

    ppo.update = recording
    try:
        yield
    finally:
        ppo.update = original


def ensemble_card_vs_cpu(short: EnvParams) -> float:
    """[10]: one ``make_ensemble_iteration`` per acting member and the
    stand-alone PPO iteration, card (K1) against CPU (plain), at default
    widths, PPO over 4 epochs (32 updates); then the ppo-acting iteration at
    PPO's default 10 epochs, where the approximate KL reaches ~0.7 and a
    ratio can cross the clip edge on one side only: the minibatch rows whose
    clip decision differs card vs CPU are counted, and PPO's parameters are
    held at PARAMS where none did, else within PARAMS plus the most Adam
    could move them from the first such update on (MAX_ADAM_STEP × its
    learning rate × those updates); SAC's and TD3's at PARAMS. Returns the
    largest parameter difference held at PARAMS."""
    cfg = ensemble.EnsembleConfig(
        sac=sac.SACConfig(**dict(DEFAULT_SAC, buffer_size=ENS_STEPS * ENS_N,
                                 learning_starts=4 * ENS_N)),
        td3=td3.TD3Config(), ppo=ppo.PPOConfig(n_epochs=PPO_HELD_EPOCHS))
    worst = 0.0
    for i, actor in enumerate(ensemble.ACTORS):
        (a, am), (b, bm) = ensemble_both(actor, cfg, short, SEED + 20 + i)
        hold_ensemble_rollout(a, b, am, bm)
        err = member_param_err(a, b)
        worst = max(worst, err)
        updates = (a.sac.step, a.td3.step, a.ppo.step)
        assert updates == (b.sac.step, b.td3.step, b.ppo.step) and a.sac.step > 0, updates
        log(f"[10] ensemble iteration, {actor} acting, {ENS_N} envs x {ENS_STEPS} steps, card "
            f"(K1) vs CPU (plain): max |d obs| {float((a.obs.cpu() - b.obs).abs().max()):.3e}, "
            f"terminations and episode ends equal ({int(b.episodes.sum())} episode ends), "
            f"SAC/TD3/PPO updates {updates}, max |d param| over the three members {err:.3e} "
            f"(atol {PARAMS['atol']}): ok")
    # PPO at its default epochs, held with its clip decisions counted
    full = dataclasses.replace(cfg, ppo=ppo.PPOConfig())
    decisions: dict = {}
    with recording_clip_decisions(decisions):
        (a, am), (b, bm) = ensemble_both("ppo", full, short, SEED + 20)
    card, host = decisions["cuda"], decisions["cpu"]
    assert len(card) == len(host) == a.ppo.step == b.ppo.step, (len(card), len(host))
    per_update = [int((x.cpu() != y).sum()) for x, y in zip(card, host)]
    flipped = sum(per_update)
    first = next((u for u, f in enumerate(per_update) if f), len(per_update))
    hold_ensemble_rollout(a, b, am, bm, [k for k in bm if not k.startswith("ppo_") or not flipped])
    for member in ("sac", "td3"):
        for net in MEMBER_NETS[member]:
            worst = max(worst, net_param_err(getattr(getattr(a, member), net),
                                             getattr(getattr(b, member), net), f"{member}.{net}"))
    torch.testing.assert_close(a.sac.log_alpha.cpu(), b.sac.log_alpha, **PARAMS)
    ppo_bound = PARAMS["atol"] + MAX_ADAM_STEP * full.ppo.learning_rate * (len(per_update) - first)
    ppo_err = max(net_param_err(getattr(a.ppo, net), getattr(b.ppo, net), f"ppo.{net}",
                                hold=not flipped) for net in MEMBER_NETS["ppo"])
    assert ppo_err <= ppo_bound, (ppo_err, ppo_bound)
    if not flipped:
        worst = max(worst, ppo_err)
    rows = sum(x.numel() for x in host)
    log(f"[10] ensemble iteration, ppo acting, {full.ppo.n_epochs} epochs ({a.ppo.step} "
        f"updates of {host[0].numel()} rows), card (K1) vs CPU (plain): clip decisions that "
        f"differ {flipped} of {rows} minibatch rows"
        + (f" (first in update {first + 1})" if flipped else "")
        + f"; max |d param| PPO {ppo_err:.3e} (held "
        + (f"within {ppo_bound:.3e} = {PARAMS['atol']} + {MAX_ADAM_STEP} x lr "
           f"{full.ppo.learning_rate} x {len(per_update) - first} updates" if flipped
           else f"at atol {PARAMS['atol']}")
        + f"), SAC/TD3 at atol {PARAMS['atol']}; clip_fraction card "
        f"{float(am['ppo_clip_fraction']):.6f}, CPU {float(bm['ppo_clip_fraction']):.6f}; "
        f"approx_kl card {float(am['ppo_approx_kl']):.6f}, CPU {float(bm['ppo_approx_kl']):.6f}"
        f"{' (PPO metrics printed, not held: rows flipped)' if flipped else ''}: ok")
    # the stand-alone PPO iteration, at the same bars
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 30)
    reset_draws = rocket_env.draw_reset(short, ENS_N, cpu, gen)
    draws = [StepDraws(n_act=torch.randn((ENS_N, 2), generator=gen),
                       n_imu=torch.randn((ENS_N, 7), generator=gen),
                       reset=rocket_env.draw_reset(short, ENS_N, cpu, gen))
             for _ in range(ENS_STEPS)]
    perms = [torch.randperm(ENS_STEPS * ENS_N, generator=gen) for _ in range(cfg.ppo.n_epochs)]
    out = {}
    for where in ("cpu", "cuda"):
        states, obs = rocket_env.reset(short, ENS_N, device=where,
                                       draws=to_device(reset_draws, where))
        it = ppo.make_train_iteration(cfg.ppo, ENS_N, ENS_STEPS, obs.shape[-1], 2)
        out[where] = it(ppo.init(obs.shape[-1], 2, cfg.ppo, device=where, seed=SEED), states,
                        obs, None, short, to_device(draws, where), to_device(perms, where))
    torch.cuda.synchronize()
    (a, a_states, a_obs, _, am), (b, b_states, b_obs, _, bm) = out["cuda"], out["cpu"]
    torch.testing.assert_close(a_obs.cpu(), b_obs, **OBS)
    assert torch.equal(a_states.step_count.cpu(), b_states.step_count), "truncation"
    for k in bm:
        torch.testing.assert_close(am[k].cpu(), bm[k], **METRICS, msg=k)
    err = 0.0
    for net in ("actor", "value"):
        for (name, p), q in zip(getattr(a, net).named_parameters(), getattr(b, net).parameters()):
            torch.testing.assert_close(p.detach().cpu(), q.detach(), **PARAMS,
                                       msg=f"{net}.{name}")
            err = max(err, float((p.detach().cpu() - q.detach()).abs().max()))
    log(f"[10] ppo.make_train_iteration {ENS_N} envs x {ENS_STEPS} steps, {a.step} updates, card "
        f"(K1) vs CPU (plain): max |d obs| {float((a_obs.cpu() - b_obs).abs().max()):.3e}, "
        f"max |d param| {err:.3e}, success_rate {float(am['success_rate']):.4f} vs "
        f"{float(bm['success_rate']):.4f}: ok")
    return max(worst, err)


def timed_ppo_learn(record: list):
    """Context: ``ppo.learn`` (GAE and the epochs) timed alone, between two
    synchronisations, each call appended to ``record`` as seconds."""
    inner = ppo.learn

    def learn(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        record.append(time.perf_counter() - t0)
        return out

    @contextlib.contextmanager
    def patched():
        ppo.learn = learn
        try:
            yield
        finally:
            ppo.learn = inner

    return patched()


def run_ensemble_trainer(scratch: Path, dev) -> dict:
    """[10b]: the ensemble trainer at the default config: one iteration with
    each actor forced, each member's eval stage, a profiled voting window,
    a trained iteration, its save and a bit-equal resume, then the ppo and
    td3 command-line routes. Returns K1's launches by path."""
    cfg = load_config(default_config_path(), ["training.algorithm=ensemble",
                                              f"training.total_timesteps={ONE_ITERATION}"])
    tr = EnsembleTrainer(cfg, output_dir=scratch / "ens", device=dev)
    n, steps = cfg.training.num_envs, cfg.training.rollout_steps
    launches: dict = {}
    learn_s: list = []
    for actor in ("sac", "td3", "ppo", "ensemble"):
        before = (tr.carry.sac.step, tr.carry.td3.step, tr.carry.ppo.step)
        torch.cuda.synchronize()
        k1.step_kernel.launches = 0
        t0 = time.perf_counter()
        with timed_ppo_learn(learn_s):
            tr.carry, metrics = tr._iterations[actor](tr.carry, tr.agent.weights_array(),
                                                      tr.env_params)
            values = {k: float(v) for k, v in metrics.items()}
        sec = time.perf_counter() - t0
        path = f"ensemble_{'voting' if actor == 'ensemble' else actor}"
        launches[path] = k1.step_kernel.launches
        assert launches[path] == steps, (actor, launches)
        assert all(map(math.isfinite, values.values())), values
        done = (tr.carry.sac.step - before[0], tr.carry.td3.step - before[1],
                tr.carry.ppo.step - before[2])
        assert done[:2] == (steps, steps), done
        phase = (f"; GAE + {cfg.algorithms.ppo.n_epochs} epochs x 8 minibatches of "
                 f"{n * steps // 8} rows {learn_s[-1]:.4f} s ({done[2]} updates, "
                 f"{learn_s[-1] / done[2] * 1e3:.3f} ms per update), rollout and off-policy "
                 f"updates {sec - learn_s[-1]:.4f} s" if actor == "ppo" else "")
        log(f"[10b] ensemble iteration, {actor} acting (default config, {n} envs x {steps} "
            f"steps, 1 SAC + 1 TD3 update per step): {sec:.4f} s ({sec / steps * 1e3:.3f} ms "
            f"per env step, {n * steps / sec:.1f} env steps/s){phase}; reward_mean "
            f"{values['reward_mean']:.4f}, sac_critic_loss {values['sac_critic_loss']:.5g}, "
            f"td3_critic_loss {values['td3_critic_loss']:.5g}; K1 launches {launches[path]}")
    tr.agent.attach_carry(tr.carry)
    # one PPO minibatch update at the default shape (65,536 rows) alone:
    # device time by CUDA events against the host's time per call
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rows = n * steps // tr.ens_cfg.ppo.num_minibatches
    obs = tr.carry.buffer.data["obs"][:rows]
    _, pre_tanh, logp, _ = ppo.act(tr.carry.ppo, obs, generator=gen)
    mb = {"obs": obs, "pre_tanh": pre_tanh, "log_prob": logp,
          "advantage": torch.randn(rows, device=dev, generator=gen),
          "return": torch.randn(rows, device=dev, generator=gen)}
    ppo_ms = device_ms(lambda: ppo.update(tr.carry.ppo, mb, tr.ens_cfg.ppo), reps=20, inner=1)
    ppo_host_ms = host_us(lambda: ppo.update(tr.carry.ppo, mb, tr.ens_cfg.ppo), reps=5,
                          inner=5) / 1e3
    log(f"[10b] one ppo.update at {rows} rows: device {ppo_ms:.4f} ms, host {ppo_host_ms:.4f} ms "
        f"per call")
    mem_mb = sum(t.numel() * t.element_size() for t in tr.carry.buffer.data.values()) / 1e6
    log(f"[10b] shared replay {tr.carry.buffer.capacity} rows, {mem_mb:.1f} MB; device memory "
        f"allocated {torch.cuda.memory_allocated() / 1e6:.1f} MB, peak "
        f"{torch.cuda.max_memory_allocated() / 1e6:.1f} MB")

    # the eval stage, each member timed and its K1 launches counted
    for name, fn in list(tr._eval_fns.items()):
        def counted(state, generator, params, draws=None, _fn=fn, _name=name):
            torch.cuda.synchronize()
            before, t0 = k1.step_kernel.launches, time.perf_counter()
            stats = _fn(state, generator, params, draws)
            ran = steps_run(stats.lengths, params.max_episode_steps)
            used = k1.step_kernel.launches - before
            assert used == ran, (_name, used, ran)
            log(f"[10b] eval stage, {_name} member: {cfg.training.eval_episodes} episodes, "
                f"{ran} steps before the early exit in {time.perf_counter() - t0:.4f} s; K1 "
                f"launches {used}")
            launches[f"ensemble_eval_{_name}"] = used
            return stats
        tr._eval_fns[name] = counted
    t0 = time.perf_counter()
    eval_metrics = tr.evaluate()
    log(f"[10b] evaluate(): {time.perf_counter() - t0:.4f} s for the three members; "
        + ", ".join(f"{k} {v:.4g}" for k, v in sorted(eval_metrics.items())
                    if k.endswith(("success_rate", "reward_mean", "length_mean"))))

    # the voting step under the profiler
    prof_it = ensemble.make_ensemble_iteration("ensemble", tr.ens_cfg, n, TRAIN_PROFILE_STEPS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.carry, _ = prof_it(tr.carry, tr.agent.weights_array(), tr.env_params)
        torch.cuda.synchronize()
        vote_ms = (time.perf_counter() - t0) / TRAIN_PROFILE_STEPS * 1e3
    device_breakdown(prof, TRAIN_PROFILE_STEPS, vote_ms, "[10b]",
                     f"profiled voting iteration, {n} envs x {TRAIN_PROFILE_STEPS} steps")
    del prof
    gc.collect()

    # one trained iteration through train(), its save, and the resume
    tr.agent.attach_carry(tr.carry)
    cfg.training.total_timesteps = tr.env_steps + ONE_ITERATION
    result = tr.train()
    final = scratch / "ens" / FINAL_CHECKPOINT
    timing = result["stage_timing"]
    assert result["iterations"] == 1 and final.exists(), (result["iterations"], final)
    assert all(math.isfinite(v) for k, v in result.items() if k.startswith(("sac_", "td3_",
                                                                            "ppo_"))), result
    resumed = EnsembleTrainer(cfg, output_dir=scratch / "ens_resumed", resume=final, device=dev)
    members = {m: getattr(tr.carry, m) for m in ensemble.ALGORITHMS}
    diffs = diff_states(members, {m: getattr(resumed.carry, m) for m in ensemble.ALGORITHMS})
    assert not diffs, diffs[:10]
    assert resumed.agent.performance_history == tr.agent.performance_history
    assert resumed.agent.algorithm_weights == tr.agent.algorithm_weights
    log(f"[10b] train(): 1 iteration ({timing['train_iteration']['mean_sec']:.4f} s), eval "
        f"{timing['evaluate']['total_sec']:.4f} s, save of {FINAL_CHECKPOINT} "
        f"{timing['checkpoint']['total_sec']:.4f} s ({final.stat().st_size} B); resume: "
        f"{len(flat_state(members))} leaves of the three members, the performance windows "
        f"and the weights equal the saved ones bit for bit: ok")
    resumed.logger.close()
    del tr, resumed, members
    gc.collect()

    # the command-line routes, in process, on the card by default, one
    # iteration each with rollout_steps cut to CLI_STEPS (a depth cut)
    steps = CLI_STEPS
    for algo in ("ppo", "td3"):
        out_dir = scratch / f"cli_{algo}"
        k1.step_kernel.launches = 0
        t0 = time.perf_counter()
        rc = train_main(["--output-dir", str(out_dir), f"training.algorithm={algo}",
                         f"training.rollout_steps={steps}",
                         f"training.total_timesteps={n * steps}"])
        sec = time.perf_counter() - t0
        used = k1.step_kernel.launches
        final_metrics = json.loads((out_dir / "final_metrics.json").read_text())
        assert rc == 0 and (out_dir / FINAL_CHECKPOINT).exists(), (rc, out_dir)
        assert final_metrics["env_steps"] == n * steps, final_metrics["env_steps"]
        # one iteration, an eval round after it and the final eval
        assert used > steps, used
        launches[f"cli_{algo}"] = used
        log(f"[10b] python -m tvc_ai_torch.train training.algorithm={algo} (in process, "
            f"default device, rollout_steps {steps}): rc {rc}, {final_metrics['env_steps']} "
            f"env steps, "
            f"{sec:.3f} s in all (train_iteration "
            f"{final_metrics['stage_timing']['train_iteration']['mean_sec']:.4f} s); "
            f"eval_success_rate {final_metrics['eval_success_rate']:.3f}; K1 launches {used} "
            f"({steps} train + {used - steps} eval steps)")
    return launches


def run_flagship(scratch: Path, dev) -> int:
    """[10c]: ``ensemble_r4.yaml`` at its widths, rollout_steps cut to 16, two
    iterations; returns K1's launches."""
    path = default_config_path().parent / "ensemble_r4.yaml"
    cfg = load_config(path, [f"training.rollout_steps={FLAGSHIP_STEPS}"])
    n = cfg.training.num_envs
    cfg.training.total_timesteps = 2 * n * FLAGSHIP_STEPS
    tr = EnsembleTrainer(cfg, output_dir=scratch / "flagship", device=dev)
    k1.step_kernel.launches = 0
    result = tr.train()
    used = k1.step_kernel.launches
    timing = result["stage_timing"]["train_iteration"]
    updates = tr.carry.sac.step + tr.carry.td3.step
    per = cfg.training.updates_per_step
    assert result["iterations"] == 2 and tr.carry.sac.step == tr.carry.td3.step, result
    # every step from the one where the replay reaches the gate,
    # max(learning_starts, batch size), takes its updates
    gate = max(tr.ens_cfg.sac.learning_starts, tr.ens_cfg.sac.batch_size)
    learned = sum((t + 1) * n >= gate for t in range(2 * FLAGSHIP_STEPS))
    assert tr.carry.sac.step == per * learned, (tr.carry.sac.step, per, learned)
    assert used >= 2 * FLAGSHIP_STEPS, used
    log(f"[10c] {path.name} ({n} envs, SAC batch {tr.ens_cfg.sac.batch_size}, {per} SAC + "
        f"{per} TD3 updates per step, selection_epsilon {tr.ens_cfg.selection_epsilon}; "
        f"rollout_steps cut from 128 to {FLAGSHIP_STEPS}, a depth cut): 2 iterations, "
        f"{timing['mean_sec']:.4f} s per iteration "
        f"({timing['total_sec'] / 2 / FLAGSHIP_STEPS * 1e3:.3f} ms per env step), {updates} "
        f"updates ({learned} of {2 * FLAGSHIP_STEPS} steps learn) in {timing['total_sec']:.4f} s = "
        f"{updates / timing['total_sec']:.1f} updates/s; final eval of "
        f"{cfg.training.eval_episodes} episodes x 3 members "
        f"{result['stage_timing']['evaluate']['total_sec']:.4f} s; eval_success_rate "
        f"{result['eval_success_rate']:.3f}; K1 launches {used}")
    return used


ROBUST_YAML = "robust_full_r4d.yaml"
ROBUST_N, ROBUST_STEPS = 256, 32       # [11a] card vs CPU, 8-step episodes
ROBUST_DROPOUT = 0.05                  # [11a]: raised from 0.01 so that drops occur
# [11a]'s success window: looser and 3 steps long, so that first successes
# (and with them the survival payout) occur within 8-step episodes beside
# truncations and crashes
ROBUST_SUCCESS = dict(max_tilt_angle=0.15, max_angular_velocity=2.0, max_horizontal_velocity=2.0,
                      max_vertical_velocity=3.0, min_altitude=0.2, max_altitude=5.0,
                      success_duration=3)
ROBUST_ROLLOUT = 16                    # [11b] rollout_steps, cut from 128
ROBUST_PROFILE_STEPS = 4               # [11b] profiled env steps once learning is on
OPTION_STEPS = 32                      # [11b] env steps per timed window, options on / off


def robust_config(overrides=()):
    return load_config(default_config_path().parent / ROBUST_YAML,
                       [f"training.rollout_steps={ROBUST_ROLLOUT}", *overrides])


def options_off(params: EnvParams) -> EnvParams:
    """``params`` with the six robust-training env options off."""
    return dataclasses.replace(
        params,
        randomization=dataclasses.replace(
            params.randomization, feasible_only=False, dr_mixture_enabled=False,
            sensor_dropout_enabled=False, actuator_delay=False),
        reward=dataclasses.replace(params.reward, survival_normalized_success=False,
                                   equilibrium_relative_shaping=False))


def reset_shares(params: EnvParams, draws, applied: torch.Tensor) -> tuple[int, int, int]:
    """Of the resets of ``draws`` that ``applied`` (N,) selects: how many,
    how many took the nominal fallback (no feasible candidate, gated hard)
    and how many the mixture gated to the nominal plant."""
    rnd = params.randomization
    ok = randomization.feasible_candidates(params.rocket, rnd, draws.u_feas, draws.n_feas)[3]
    hard = randomization.mixture_hard(rnd, draws.u_dr)
    return (int(applied.sum()), int((applied & hard & ~ok.any(dim=1)).sum()),
            int((applied & ~hard).sum()))


def robust_card_vs_cpu(dev) -> None:
    """[11a]: ``batched_step_autoreset`` with every robust-training option on,
    card (K1) against CPU (plain) on the same draws, 256 envs x 32 steps of
    8-step episodes with a looser 3-step success window: the env bars, ``dr``
    at 1e-6 (the feasible candidate and the mixture gate chosen alike) and
    the held readings of the dropped steps equal on both."""
    cfg = robust_config()
    base = build_env_params(cfg)
    params = dataclasses.replace(
        base, max_episode_steps=8, success=dataclasses.replace(base.success, **ROBUST_SUCCESS),
        randomization=dataclasses.replace(base.randomization, sensor_dropout_prob=ROBUST_DROPOUT),
        reward=dataclasses.replace(base.reward, equilibrium_relative_shaping=True))
    rnd = params.randomization
    assert (rnd.feasible_only and rnd.dr_mixture_enabled and rnd.sensor_dropout_enabled
            and rnd.actuator_delay and rnd.sensor_noise_uniform and rnd.progress_rate_randomized
            and params.reward.survival_normalized_success and params.drift_obs_enabled), params
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 40)
    n = ROBUST_N
    reset0 = rocket_env.draw_reset(params, n, cpu, gen)
    steps = [dict(actions=torch.rand((n, 2), generator=gen) * 2.0 - 1.0,
                  n_imu=torch.randn((n, 7), generator=gen),
                  u_drop=torch.rand((n,), generator=gen),
                  reset_draws=rocket_env.draw_reset(params, n, cpu, gen))
             for _ in range(ROBUST_STEPS)]
    runs = []
    for where in (dev, cpu):
        states, _ = rocket_env.reset(params, n, device=where, draws=to_device(reset0, where))
        k1.step_kernel.launches = 0
        rows = []
        for d in steps:
            prev = states
            states, out, nxt = rocket_env.batched_step_autoreset(
                states, d["actions"].to(where), params, n_imu=d["n_imu"].to(where),
                reset_draws=to_device(d["reset_draws"], where), u_drop=d["u_drop"].to(where))
            rows.append((prev, out, nxt, states))
        runs.append((rows, k1.step_kernel.launches))
    torch.cuda.synchronize()
    (card, card_launches), (host, host_launches) = runs
    assert (card_launches, host_launches) == (ROBUST_STEPS, 0), (card_launches, host_launches)
    worst = dict(obs=0.0, reward=0.0, dr=0.0)
    applied = [torch.ones(n, dtype=torch.bool)]
    for t, ((a_prev, a, a_next, a_s), (b_prev, b, b_next, b_s)) in enumerate(zip(card, host)):
        what = f"[11a] step {t}"
        torch.testing.assert_close(a.obs.cpu(), b.obs, **OBS, msg=what)
        torch.testing.assert_close(a_next.cpu(), b_next, **OBS, msg=what)
        torch.testing.assert_close(a.reward.cpu(), b.reward, **REWARD, msg=what)
        for flag in ("terminated", "truncated", "mission_success", "crashed"):
            assert torch.equal(getattr(a, flag).cpu(), getattr(b, flag)), f"{what} {flag}"
        for f in dataclasses.fields(a_s.dr):
            torch.testing.assert_close(getattr(a_s.dr, f.name).cpu(), getattr(b_s.dr, f.name),
                                       atol=1e-6, rtol=1e-6, msg=f"{what} dr.{f.name}")
            worst["dr"] = max(worst["dr"], float(
                (getattr(a_s.dr, f.name).cpu() - getattr(b_s.dr, f.name)).abs().max()))
        torch.testing.assert_close(a_s.prev_imu.cpu(), b_s.prev_imu, **OBS, msg=what)
        drop = steps[t]["u_drop"] < rnd.sensor_dropout_prob
        assert torch.equal(a.obs[:, :7].cpu()[drop], a_prev.prev_imu.cpu()[drop]), what
        assert torch.equal(b.obs[:, :7][drop], b_prev.prev_imu[drop]), what
        worst["obs"] = max(worst["obs"], float((a.obs.cpu() - b.obs).abs().max()))
        worst["reward"] = max(worst["reward"], float((a.reward.cpu() - b.reward).abs().max()))
        applied.append(b.terminated | b.truncated)
    counts = [reset_shares(params, d, m) for d, m in
              zip([reset0] + [d["reset_draws"] for d in steps], applied)]
    resets, fallback, gated = (sum(c[i] for c in counts) for i in range(3))
    drops = sum(int((d["u_drop"] < rnd.sensor_dropout_prob).sum()) for d in steps)
    paid = sum(int((b.mission_success & ~b_prev.mission_success).sum())
               for b_prev, b, _, _ in host)
    assert fallback > 0 and gated > 0 and drops > 0 and paid > 0, (fallback, gated, drops, paid)
    log(f"[11a] batched_step_autoreset, every robust-training option on ({ROBUST_YAML}'s box, "
        f"feasible_only x{rnd.feasible_tries}, dr_prob {rnd.dr_prob:.3g}, dropout "
        f"{rnd.sensor_dropout_prob:.3g}, actuator delay, survival payout, equilibrium shaping, noise "
        f"uniform, progress-rate DR, drift obs), {n} envs x {ROBUST_STEPS} steps, card (K1) vs "
        f"CPU (plain): max |d obs| {worst['obs']:.3e}, max |d reward| {worst['reward']:.3e}, "
        f"max |d dr| {worst['dr']:.3e}; flags, feasible choice, mixture gate and held readings "
        f"equal; K1 launches {card_launches}: ok")
    log(f"[11a] shares: {fallback} of {resets} resets took the nominal fallback "
        f"({fallback / resets:.2%}), {gated} of {resets} were gated to the nominal plant by the "
        f"mixture ({gated / resets:.2%}), {drops} of {n * ROBUST_STEPS} readings dropped "
        f"({drops / (n * ROBUST_STEPS):.2%}); {paid} first-success steps (each with the "
        f"survival payout)")


def counted_feasibility() -> tuple[contextlib.AbstractContextManager, dict]:
    """A context in which every feasible-only domain draw adds, on the
    device (no host read), its draws and those with no feasible candidate
    to ``counts``."""
    counts: dict = {}
    inner = randomization.feasible_draw_mask

    def mask(*args, **kwargs):
        ok = inner(*args, **kwargs)
        none = (~ok.any(dim=1)).sum()
        counts["none"] = counts["none"] + none if "none" in counts else none
        counts["draws"] = counts.get("draws", 0) + ok.shape[0]
        return ok

    @contextlib.contextmanager
    def patched():
        randomization.feasible_draw_mask = mask
        try:
            yield
        finally:
            randomization.feasible_draw_mask = inner

    return patched(), counts


def run_robust_trainer(scratch: Path, dev, overrides=()) -> int:
    """[11b] and [11c]: ``Trainer`` on ``robust_full_r4d.yaml`` at its widths
    with ``rollout_steps`` cut to 16, two iterations and its final eval
    (nominal, robust, stage); the options' own cost on the env step timed
    in turns; a profiled window of 4 learning steps; the resume from the
    final checkpoint, bit for bit. Returns the two iterations' K1 launches."""
    cfg = robust_config(overrides)
    n = cfg.training.num_envs
    cfg.training.total_timesteps = 2 * n * ROBUST_ROLLOUT
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, output_dir=scratch / "robust", device=dev)
    rnd = tr.env_params.randomization
    evals: list = []
    counting_evals(tr, evals)
    feasibility, feas_counts = counted_feasibility()
    k1.step_kernel.launches = 0
    with feasibility:
        result = tr.train()
    launches = k1.step_kernel.launches
    timing = result["stage_timing"]
    iters = result["iterations"]
    assert iters == 2 and result["env_steps"] == 2 * n * ROBUST_ROLLOUT, result
    assert launches == iters * ROBUST_ROLLOUT + sum(k for k, _, _ in evals), (launches, evals)
    assert len(evals) == 3, evals    # the final eval: nominal, robust, stage
    metrics = {k: v for k, v in result.items() if k.startswith("eval_")}
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    per = cfg.training.updates_per_step
    learned = sum((t + 1) * n >= tr.sac_cfg.learning_starts for t in range(2 * ROBUST_ROLLOUT))
    assert tr.carry.agent.step == per * learned, (tr.carry.agent.step, per, learned)
    train_s = timing["train_iteration"]["total_sec"]
    data = tr.carry.buffer.data
    rows = tr.carry.buffer.size
    dropped = int((data["next_obs"][:rows, :7] == data["obs"][:rows, :7]).all(dim=1).sum())
    none = int(feas_counts["none"])
    log(f"[11b] {ROBUST_YAML} ({n} envs, SAC batch {tr.sac_cfg.batch_size}, {per} updates per "
        f"step, obs {tr.loop_cfg.obs_dim} with drift, curriculum stage {tr.curriculum.stage_idx}: "
        f"feasible_only {rnd.feasible_only} x{rnd.feasible_tries}, mixture "
        f"{rnd.dr_mixture_enabled} (dr_prob {rnd.dr_prob:.3g}), dropout "
        f"{rnd.sensor_dropout_prob:.3g}, "
        f"actuator delay {rnd.actuator_delay}, survival payout "
        f"{tr.env_params.reward.survival_normalized_success}; rollout_steps cut from 128 to "
        f"{ROBUST_ROLLOUT}, a depth cut): {iters} iterations, "
        f"{timing['train_iteration']['mean_sec']:.4f} s per iteration "
        f"({train_s / iters / ROBUST_ROLLOUT * 1e3:.3f} ms per env step), {tr.carry.agent.step} "
        f"updates ({learned} of {iters * ROBUST_ROLLOUT} steps learn) in {train_s:.4f} s = "
        f"{tr.carry.agent.step / train_s:.1f} updates/s; K1 launches {launches} == {iters} x "
        f"{ROBUST_ROLLOUT} + {launches - iters * ROBUST_ROLLOUT} eval steps")
    for name in ("train_iteration", "evaluate", "checkpoint"):
        if name in timing:
            log(f"[11b] trainer stage {name}: {timing[name]['total_sec']:.4f} s in all, "
                f"{timing[name]['count']}x, mean {timing[name]['mean_sec']:.4f} s")
    log("[11b] final eval rounds (nominal, robust, stage; "
        f"{cfg.training.eval_episodes} episodes each): "
        + ", ".join(f"{sec:.4f} s ({ran} steps before the early exit, K1 launches {k})"
                    for k, ran, sec in evals)
        + "; " + ", ".join(f"{k} {v:.4g}" for k, v in sorted(metrics.items())
                           if k.endswith(("success_rate", "reward_mean"))))
    log(f"[11b] seen in training: {none} of {feas_counts['draws']} feasible-only reset draws "
        f"fell back to the nominal plant ({none / feas_counts['draws']:.2%}); mixture gate "
        f"{'on' if rnd.dr_mixture_enabled else 'off at this stage (dr_prob 1)'}; {dropped} of "
        f"{rows} replay transitions hold a dropped reading ({dropped / rows:.2%}); device memory "
        f"peak {torch.cuda.max_memory_allocated() / 1e6:.1f} MB (replay "
        f"{sum(t.numel() * t.element_size() for t in data.values()) / 1e6:.1f} MB)")

    # ---- 11c. resume from the final checkpoint: the carry (prev_imu
    # included) and both generators bit for bit
    phase("[11c]")
    final = scratch / "robust" / "checkpoints"
    resumed = Trainer(cfg, output_dir=scratch / "robust_resumed", resume=final, device=dev)
    saved = {"carry": tr.carry, "generator": tr.generator}
    diffs = diff_states(saved, {"carry": resumed.carry, "generator": resumed.generator})
    assert not diffs, diffs[:10]
    assert resumed.carry.env_states.prev_imu is not None and resumed.env_steps == tr.env_steps
    log(f"[11c] resume from {final.name}/{tr.env_steps}: carry (prev_imu included) and both "
        f"generators equal the saved ones bit for bit ({len(flat_state(saved))} leaves): ok")
    resumed.logger.close()
    del resumed

    # ---- the options' own cost on the env step: the base box with every
    # option on against the same env with them off, in turns
    phase("[11b] options on/off")
    on = build_env_params(cfg)
    off = options_off(on)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    actions = torch.rand((n, 2), generator=gen, device=dev) * 2.0 - 1.0
    start = {name: rocket_env.reset(p, n, device=dev, generator=gen)[0]
             for name, p in (("on", on), ("off", off))}
    env = {"on": on, "off": off}

    def window(name):
        states = start[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OPTION_STEPS):
            states, _, _ = rocket_env.batched_step_autoreset(states, actions, env[name],
                                                             generator=gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / OPTION_STEPS * 1e3

    def one_step(name):
        return lambda: rocket_env.batched_step_autoreset(start[name], actions, env[name],
                                                         generator=gen)

    window("on"), window("off")   # warm-up
    host_ms = in_turns({"on": "on", "off": "off"}, window)
    dev_ms = in_turns({"on": "on", "off": "off"},
                      lambda name: device_ms(one_step(name), reps=10, inner=3))
    ops = {}
    for name in ("on", "off"):
        # device activity only: a host trace of these windows costs seconds to
        # process and is not read
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            window(name)
            prof_ms = (time.perf_counter() - t0) / OPTION_STEPS * 1e3
        ops[name] = device_breakdown(prof, OPTION_STEPS, prof_ms, "[11b]",
                                     f"profiled env step, options {name}, {n} envs", top=0)
        del prof
    gc.collect()
    log(f"[11b] env step at {n} envs, options on vs off, in turns (on off off on): host "
        f"{host_ms['on'][0]:.4f}, {host_ms['on'][1]:.4f} vs {host_ms['off'][0]:.4f}, "
        f"{host_ms['off'][1]:.4f} ms per step; device {dev_ms['on'][0]:.5f}, "
        f"{dev_ms['on'][1]:.5f} vs {dev_ms['off'][0]:.5f}, {dev_ms['off'][1]:.5f} ms per step; "
        f"device operations per step {ops['on']['ops']:.1f} vs {ops['off']['ops']:.1f}")

    # ---- 4 learning steps under the profiler
    phase("[11b] profile")
    prof_it = loop.make_train_iteration(
        tr.sac_cfg, dataclasses.replace(tr.loop_cfg, rollout_steps=ROBUST_PROFILE_STEPS))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.carry, _ = prof_it(tr.carry, tr.env_params)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / ROBUST_PROFILE_STEPS * 1e3
    device_breakdown(prof, ROBUST_PROFILE_STEPS, step_ms, "[11b]",
                     f"profiled train iteration, {n} envs x {ROBUST_PROFILE_STEPS} steps, "
                     f"{per} updates per step", top=8)
    del prof, tr
    gc.collect()
    return launches


TRANSFORMER_YAML = "transformer_r3.yaml"
TF_BATCH, TF_UPDATES, TF_ACT_N = 256, 10, 512   # [12a] card vs CPU
TF_ROLLOUT = 16                                 # [12b] rollout_steps, cut from 128
TF_PROFILE_STEPS = 2                            # [12b] profiled learning steps
EXT_N, EXT_STEPS = 256, 8                       # [12c] card vs CPU, 8-step episodes
EXT_RND_EVERY = 3                               # [12c] card vs CPU: RND updates at steps 0, 3, 6
EXT_ROLLOUT = 32                                # [12c] trainer rollout_steps, cut from 128
EXT_COST_STEPS = 16                             # [12c] env steps per timed window, on / off
EXTENSIONS_ON = ["exploration.curiosity.enabled=true",
                 "exploration.random_network_distillation.enabled=true",
                 "physics_informed.enabled=true", "hierarchical_rl.enabled=true"]


def transformer_config(overrides=()):
    return load_config(default_config_path().parent / TRANSFORMER_YAML, list(overrides))


def transformer_card_vs_cpu(dev) -> float:
    """[12a]: ten ``sac.update``s at batch 256 with ``transformer_r3.yaml``'s
    actor (d_model 128, 8 heads, 2 layers, a 40-wide history-4 input) and an
    EMA actor, then one act at 512, card against CPU from the same weights on
    the same batches and draws; returns the largest parameter difference."""
    cfg = dataclasses.replace(build_sac_config(transformer_config()), batch_size=TF_BATCH)
    n_obs = 10 * transformer_config().network.history_len
    gen = torch.Generator().manual_seed(SEED + 50)

    def batch():
        return {"obs": torch.randn((TF_BATCH, n_obs), generator=gen),
                "action": torch.rand((TF_BATCH, 2), generator=gen) * 2.0 - 1.0,
                "reward": torch.randn(TF_BATCH, generator=gen) * 30.0,
                "next_obs": torch.randn((TF_BATCH, n_obs), generator=gen),
                "done": (torch.rand(TF_BATCH, generator=gen) < 0.1).to(torch.float32)}

    batches = [batch() for _ in range(TF_UPDATES)]
    draws = [sac.UpdateDraws(n_next=torch.randn((TF_BATCH, 2), generator=gen),
                             n_pi=torch.randn((TF_BATCH, 2), generator=gen))
             for _ in range(TF_UPDATES)]
    act_obs, act_noise = torch.randn((TF_ACT_N, n_obs), generator=gen), torch.randn(
        (TF_ACT_N, 2), generator=gen)
    out = []
    for where in (torch.device("cpu"), dev):
        agent = sac.init(n_obs, 2, cfg, device=where, seed=SEED)
        for b, d in zip(batches, draws):
            agent, metrics = sac.update(agent, {k: v.to(where) for k, v in b.items()}, cfg,
                                        to_device(d, where))
        act = sac.select_action(agent.actor, act_obs.to(where), act_noise.to(where))
        out.append((agent, metrics, act))
    torch.cuda.synchronize()
    (b, bm, b_act), (a, am, a_act) = out
    assert isinstance(a.actor, TransformerActor) and a.step == b.step == TF_UPDATES
    err = max(net_param_err(getattr(a, net), getattr(b, net), net)
              for net in ("actor", "critic", "target_critic", "ema_actor"))
    torch.testing.assert_close(a.log_alpha.cpu(), b.log_alpha, **PARAMS)
    torch.testing.assert_close(a_act.cpu(), b_act, **PARAMS)
    for k in bm:
        torch.testing.assert_close(am[k].cpu(), bm[k], **METRICS, msg=k)
    n_tensors = len(list(a.actor.parameters()))
    log(f"[12a] transformer actor ({TRANSFORMER_YAML}: d_model {cfg.transformer_d_model}, "
        f"{cfg.transformer_heads} heads, {cfg.transformer_layers} layers, feed-forward 512, heads "
        f"(512, 512), {n_tensors} parameter tensors, "
        f"{sum(p.numel() for p in a.actor.parameters())} parameters; obs {n_obs}), "
        f"{TF_UPDATES} sac.update at batch {TF_BATCH} with the EMA actor, card vs CPU: max |d "
        f"param| {err:.3e} (atol {PARAMS['atol']}), one act at {TF_ACT_N}: max |d action| "
        f"{float((a_act.cpu() - b_act).abs().max()):.3e}; actor_loss {float(am['actor_loss']):.6g} "
        f"vs {float(bm['actor_loss']):.6g}: ok")
    return err


def run_transformer_trainer(scratch: Path, dev) -> int:
    """[12b]: ``Trainer`` on ``transformer_r3.yaml`` at its widths with
    ``rollout_steps`` cut to 16, two iterations and its final eval, the
    resume from the final checkpoint bit for bit, a profiled learning step,
    and one ``sac.update`` at batch 1024 timed alone. Returns the two
    iterations' K1 launches."""
    cfg = transformer_config([f"training.rollout_steps={TF_ROLLOUT}"])
    n = cfg.training.num_envs
    cfg.training.total_timesteps = 2 * n * TF_ROLLOUT
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, output_dir=scratch / "transformer", device=dev)
    assert isinstance(tr.carry.agent.actor, TransformerActor)
    evals: list = []
    counting_evals(tr, evals)
    k1.step_kernel.launches = 0
    result = tr.train()
    launches = k1.step_kernel.launches
    timing = result["stage_timing"]
    iters = result["iterations"]
    assert iters == 2 and result["env_steps"] == 2 * n * TF_ROLLOUT, result
    assert launches == iters * TF_ROLLOUT + sum(k for k, _, _ in evals), (launches, evals)
    metrics = {k: v for k, v in result.items() if k.startswith("eval_")}
    assert evals and all(math.isfinite(v) for v in metrics.values()), metrics
    per = cfg.training.updates_per_step
    learned = sum((t + 1) * n >= tr.sac_cfg.learning_starts for t in range(2 * TF_ROLLOUT))
    assert tr.carry.agent.step == per * learned, (tr.carry.agent.step, per, learned)
    train_s = timing["train_iteration"]["total_sec"]
    data = tr.carry.buffer.data
    replay_mb = sum(t.numel() * t.element_size() for t in data.values()) / 1e6
    log(f"[12b] {TRANSFORMER_YAML} ({n} envs, history {tr.loop_cfg.history_len}: obs "
        f"{data['obs'].shape[1]}, SAC batch {tr.sac_cfg.batch_size}, {per} updates per step, "
        f"ent_coef {tr.sac_cfg.alpha:g} fixed, EMA {tr.sac_cfg.ema_decay:g}; rollout_steps cut from "
        f"128 to {TF_ROLLOUT}, a depth cut): {iters} iterations, "
        f"{timing['train_iteration']['mean_sec']:.4f} s per iteration "
        f"({train_s / iters / TF_ROLLOUT * 1e3:.3f} ms per env step), {tr.carry.agent.step} "
        f"updates ({learned} of {iters * TF_ROLLOUT} steps learn) in {train_s:.4f} s = "
        f"{tr.carry.agent.step / train_s:.1f} updates/s; K1 launches {launches} == {iters} x "
        f"{TF_ROLLOUT} + {launches - iters * TF_ROLLOUT} eval steps")
    log("[12b] final eval rounds (" + f"{cfg.training.eval_episodes} episodes each): "
        + ", ".join(f"{sec:.4f} s ({ran} steps before the early exit, K1 launches {k})"
                    for k, ran, sec in evals)
        + "; " + ", ".join(f"{k} {v:.4g}" for k, v in sorted(metrics.items())
                           if k.endswith(("success_rate", "reward_mean"))))
    log(f"[12b] replay {tr.carry.buffer.capacity} rows x "
        f"{sum(t[0].numel() for t in data.values())} float32 = {replay_mb:.1f} MB; device memory "
        f"peak {torch.cuda.max_memory_allocated() / 1e6:.1f} MB")

    # the resume from the final checkpoint, bit for bit
    final = scratch / "transformer" / "checkpoints"
    resumed = Trainer(cfg, output_dir=scratch / "transformer_resumed", resume=final, device=dev)
    saved = {"carry": tr.carry, "generator": tr.generator}
    diffs = diff_states(saved, {"carry": resumed.carry, "generator": resumed.generator})
    assert not diffs, diffs[:10]
    log(f"[12b] resume from {final.name}/{tr.env_steps}: carry (transformer actor, EMA actor, "
        f"Adam states) and both generators equal the saved ones bit for bit "
        f"({len(flat_state(saved))} leaves): ok")
    resumed.logger.close()
    del resumed

    # learning steps under the profiler (device activity only)
    prof_it = loop.make_train_iteration(
        tr.sac_cfg, dataclasses.replace(tr.loop_cfg, rollout_steps=TF_PROFILE_STEPS))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.carry, _ = prof_it(tr.carry, tr.env_params)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / TF_PROFILE_STEPS * 1e3
    device_breakdown(prof, TF_PROFILE_STEPS, step_ms, "[12b]",
                     f"profiled train iteration, {n} envs x {TF_PROFILE_STEPS} steps, {per} "
                     f"updates per step", top=8)
    del prof
    gc.collect()
    # one sac.update at the run's batch alone
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    batch = replay.sample(tr.carry.buffer, tr.sac_cfg.batch_size, generator=gen)
    update_ms = device_ms(lambda: sac.update(tr.carry.agent, batch, tr.sac_cfg, generator=gen),
                          reps=20, inner=1)
    update_host_ms = host_us(lambda: sac.update(tr.carry.agent, batch, tr.sac_cfg, generator=gen),
                             reps=5, inner=5) / 1e3
    log(f"[12b] sac.update with the transformer actor at batch {tr.sac_cfg.batch_size}: device "
        f"{update_ms:.4f} ms, host {update_host_ms:.4f} ms per call")
    tr.logger.close()
    del tr
    gc.collect()
    return launches


def extension_draws(params: EnvParams, sac_cfg: sac.SACConfig, loop_cfg: loop.TrainLoopConfig,
                    gen: torch.Generator) -> list:
    """Every draw of one [12c] iteration on the CPU: each step's action
    noise, IMU noise, autoreset and fresh goals' Gumbel draws, and the replay
    rows and noise of each update once the gate opens."""
    cpu, n, b = torch.device("cpu"), loop_cfg.num_envs, sac_cfg.batch_size
    out = []
    for t in range(loop_cfg.rollout_steps):
        size = (t + 1) * n
        out.append(IterDraws(
            step=StepDraws(n_act=torch.randn((n, 2), generator=gen),
                           n_imu=torch.randn((n, 7), generator=gen),
                           reset=rocket_env.draw_reset(params, n, cpu, gen),
                           g_goal=hier_mod.gumbel((n, loop_cfg.hierarchical.num_goals), cpu, gen)),
            samples=[SampleDraws(idx=torch.randint(0, size, (b,), generator=gen),
                                 update=sac.UpdateDraws(n_next=torch.randn((b, 2), generator=gen),
                                                        n_pi=torch.randn((b, 2), generator=gen)))
                     ] if size >= sac_cfg.learning_starts else []))
    return out


def extensions_card_vs_cpu(dev) -> None:
    """[12c]: one train iteration with ICM, the physics-informed loss, RND
    and hierarchical RL on, 256 envs x 8 steps of 8-step episodes at the
    default widths, card (K1) against CPU (plain) from the same initial state
    and goals on the same draws: the goals equal, the ICM, RND, high-level
    and SAC parameters within 1e-4, the env at its bars."""
    cfg = load_config(default_config_path(), EXTENSIONS_ON + [
        f"exploration.random_network_distillation.update_frequency={EXT_RND_EVERY}"])
    sac_cfg = dataclasses.replace(build_sac_config(cfg), buffer_size=32 * EXT_N,
                                  learning_starts=2 * EXT_N)
    loop_cfg = dataclasses.replace(build_loop_config(cfg), num_envs=EXT_N, rollout_steps=EXT_STEPS)
    base = build_env_params(cfg, cfg.curriculum.stages[0])
    params = dataclasses.replace(base, max_episode_steps=8)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 60)
    reset0 = rocket_env.draw_reset(params, EXT_N, cpu, gen)
    g0 = hier_mod.gumbel((EXT_N, loop_cfg.hierarchical.num_goals), cpu, gen)
    draws = extension_draws(params, sac_cfg, loop_cfg, gen)
    out, goal0 = [], None
    for where in (cpu, dev):
        carry = loop.init_carry(params, sac_cfg, loop_cfg, device=where, seed=SEED,
                                reset_draws=to_device(reset0, where))
        if goal0 is None:   # the first goals, chosen on the CPU for both
            goal0 = hier_mod.sample_goal(carry.hier, carry.goal_obs, loop_cfg.hierarchical, g0)
        carry.goal = goal0.to(where)
        k1.step_kernel.launches = 0
        it = loop.make_train_iteration(sac_cfg, loop_cfg)
        out.append((*it(carry, params, to_device(draws, where)), k1.step_kernel.launches))
    torch.cuda.synchronize()
    (b, bm, b_launches), (a, am, a_launches) = out
    # K1 once per step on the card, never on the CPU
    assert (a_launches, b_launches) == (EXT_STEPS if dev.type == "cuda" else 0, 0), (
        a_launches, b_launches)
    torch.testing.assert_close(a.obs.cpu(), b.obs, **OBS)
    for k in ("obs", "next_obs", "action"):
        torch.testing.assert_close(a.buffer.data[k].cpu(), b.buffer.data[k], **OBS, msg=k)
    torch.testing.assert_close(a.buffer.data["reward"].cpu(), b.buffer.data["reward"], **REWARD)
    assert torch.equal(a.buffer.data["done"].cpu(), b.buffer.data["done"]), "terminated differs"
    for name in ("episodes", "successes", "ep_length", "ep_ring_seq", "ep_ring_ptr", "goal",
                 "ep_ring_goal"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), f"{name} differs"
    torch.testing.assert_close(a.goal_obs.cpu(), b.goal_obs, **OBS)
    for k in bm:
        torch.testing.assert_close(am[k].cpu(), bm[k], **METRICS, msg=k)
    errs = {
        "sac": max(net_param_err(getattr(a.agent, net), getattr(b.agent, net), net)
                   for net in ("actor", "critic", "target_critic")),
        "icm": net_param_err(a.icm.nets, b.icm.nets, "icm"),
        "rnd": net_param_err(a.rnd.predictor, b.rnd.predictor, "rnd"),
        "high": net_param_err(a.hier.policy, b.hier.policy, "high"),
    }
    for name in ("bonus_mean", "bonus_var"):
        torch.testing.assert_close(getattr(a.rnd, name).cpu(), getattr(b.rnd, name), **PARAMS,
                                   msg=name)
    torch.testing.assert_close(a.hier.baseline.cpu(), b.hier.baseline, **REWARD)
    steps = (a.agent.step, a.icm.step, a.rnd.step, int(a.hier.step), int(a.hier.opt.count))
    assert steps == (b.agent.step, b.icm.step, b.rnd.step, int(b.hier.step),
                     int(b.hier.opt.count)), steps
    assert a.agent.step > 0 and a.icm.step == EXT_STEPS and a.rnd.step == 3, steps
    assert int(a.hier.step) == 1 and int(b.episodes.sum()) >= EXT_N, (steps, int(b.episodes.sum()))
    log(f"[12c] train iteration with ICM + physics-informed loss + RND (every {EXT_RND_EVERY} "
        f"steps) + hierarchical RL, default widths, {EXT_N} envs x {EXT_STEPS} steps, card (K1) "
        f"vs CPU (plain): max |d obs| {float((a.obs.cpu() - b.obs).abs().max()):.3e}, max |d "
        f"replay reward| "
        f"{float((a.buffer.data['reward'].cpu() - b.buffer.data['reward']).abs().max()):.3e}; "
        f"goals and goal ring equal ({int(b.episodes.sum())} episode ends, goals "
        f"{torch.bincount(b.goal.long(), minlength=4).tolist()}); max |d param| SAC "
        f"{errs['sac']:.3e}, ICM {errs['icm']:.3e}, RND {errs['rnd']:.3e}, high level "
        f"{errs['high']:.3e} (atol {PARAMS['atol']}); SAC/ICM/RND/high updates {steps[:4]}; "
        f"K1 launches {a_launches}: ok")


def run_extension_trainer(scratch: Path, dev) -> int:
    """[12c]: ``Trainer`` at the default config (4096 envs) with the four
    extensions on, one 32-step iteration, its hierarchical final eval and the
    resume from its final checkpoint bit for bit; then the env step's cost
    with the extensions on against off, in turns. Returns the trainer's K1
    launches."""
    cfg = load_config(default_config_path(), EXTENSIONS_ON
                      + [f"training.rollout_steps={EXT_ROLLOUT}"])
    n = cfg.training.num_envs
    cfg.training.total_timesteps = n * EXT_ROLLOUT
    tr = Trainer(cfg, output_dir=scratch / "extensions", device=dev)
    agents: list = []
    inner = tr._eval_fn

    def recording(agent, generator, params, draws=None):
        agents.append(agent)
        return inner(agent, generator, params, draws)

    tr._eval_fn = recording
    evals: list = []
    counting_evals(tr, evals)
    k1.step_kernel.launches = 0
    result = tr.train()
    launches = k1.step_kernel.launches
    timing = result["stage_timing"]
    c = tr.carry
    assert result["iterations"] == 1 and result["env_steps"] == n * EXT_ROLLOUT, result
    assert launches == EXT_ROLLOUT + sum(k for k, _, _ in evals), (launches, evals)
    assert agents and all(isinstance(x, tuple) and x[1] is c.hier for x in agents)
    assert c.icm.step == EXT_ROLLOUT and c.env_steps_host == EXT_ROLLOUT
    every = tr.loop_cfg.rnd.update_frequency
    assert c.rnd.step == len(range(0, EXT_ROLLOUT, every)), c.rnd.step
    metrics = {k: v for k, v in result.items() if k.startswith("eval_")}
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    goals = torch.bincount(c.goal.long(), minlength=tr.loop_cfg.hierarchical.num_goals).tolist()
    log(f"[12c] Trainer, default config with ICM + physics-informed + RND + hierarchical "
        f"({n} envs, rollout_steps cut from 128 to {EXT_ROLLOUT}, a depth cut): 1 iteration "
        f"{timing['train_iteration']['mean_sec']:.4f} s "
        f"({timing['train_iteration']['mean_sec'] / EXT_ROLLOUT * 1e3:.3f} ms per env step), "
        f"{c.agent.step} SAC / {c.icm.step} ICM / {c.rnd.step} RND / {int(c.hier.step)} "
        f"high-level updates, high-level baseline {float(c.hier.baseline):.4g}, goals now "
        f"{goals}; hierarchical final eval ({len(evals)} rounds): "
        + ", ".join(f"{sec:.4f} s ({ran} steps)" for _, ran, sec in evals)
        + f"; eval_success_rate {metrics['eval_success_rate']:.3f}; K1 launches {launches} "
        f"== {EXT_ROLLOUT} + {launches - EXT_ROLLOUT} eval steps")
    final = scratch / "extensions" / "checkpoints"
    resumed = Trainer(cfg, output_dir=scratch / "extensions_resumed", resume=final, device=dev)
    saved = {"carry": tr.carry, "generator": tr.generator}
    diffs = diff_states(saved, {"carry": resumed.carry, "generator": resumed.generator})
    assert not diffs, diffs[:10]
    assert resumed.carry.env_steps_host == c.env_steps_host
    log(f"[12c] resume from {final.name}/{tr.env_steps}: carry (ICM, RND, high level, goals, "
        f"goal ring, env_steps_host) and both generators equal the saved ones bit for bit "
        f"({len(flat_state(saved))} leaves): ok")
    resumed.logger.close()
    # one more iteration under set_sync_debug_mode("error"): the ICM, RND
    # and goal branches and the high level's masked step make no
    # host-device synchronisation
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        tr.carry, _ = tr._train_fn(tr.carry, tr.env_params)
        sync_free_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert tr.carry.env_steps_host == 2 * EXT_ROLLOUT, tr.carry.env_steps_host
    log(f"[12c] under set_sync_debug_mode('error'): one more iteration with the four extensions "
        f"enqueued in {sync_free_ms:.1f} ms with no host-device synchronisation (high-level "
        f"steps {int(tr.carry.hier.step)}, Adam count {int(tr.carry.hier.opt.count)}): ok")
    tr.logger.close()
    params = tr.env_params
    del tr, resumed, c, saved
    gc.collect()

    # the env step's extra cost: the loop with no SAC update (the gate
    # closed) with the four extensions on against off, in turns
    phase("[12c] extensions on/off")
    on_loop = dataclasses.replace(build_loop_config(cfg), rollout_steps=EXT_COST_STEPS)
    off_loop = dataclasses.replace(on_loop, use_curiosity=False, use_physics_informed=False,
                                   use_rnd=False, use_hierarchical=False)
    no_learn = dataclasses.replace(build_sac_config(cfg), buffer_size=4 * EXT_COST_STEPS * n,
                                   learning_starts=10**12)
    its = {name: loop.make_train_iteration(no_learn, lc)
           for name, lc in (("on", on_loop), ("off", off_loop))}
    carries = {name: loop.init_carry(params, no_learn, lc, device=dev, seed=SEED + 61)
               for name, lc in (("on", on_loop), ("off", off_loop))}

    def window(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carries[name], _ = its[name](carries[name], params)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / EXT_COST_STEPS * 1e3

    window("on"), window("off")   # warm-up
    host_ms = in_turns({"on": "on", "off": "off"}, window)
    ops = {}
    for name in ("on", "off"):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            window(name)
            prof_ms = (time.perf_counter() - t0) / EXT_COST_STEPS * 1e3
        ops[name] = device_breakdown(prof, EXT_COST_STEPS, prof_ms, "[12c]",
                                     f"profiled env step (no SAC update), extensions {name}, "
                                     f"{n} envs", top=0)
        del prof
    gc.collect()
    log(f"[12c] env step at {n} envs without SAC updates, extensions on vs off, in turns (on off "
        f"off on): host {host_ms['on'][0]:.4f}, {host_ms['on'][1]:.4f} vs {host_ms['off'][0]:.4f}, "
        f"{host_ms['off'][1]:.4f} ms per step; device busy {ops['on']['busy']:.5f} vs "
        f"{ops['off']['busy']:.5f} ms per step; device operations per step {ops['on']['ops']:.1f} "
        f"vs {ops['off']['ops']:.1f} (RND updates every {on_loop.rnd.update_frequency} steps)")
    del carries, its
    gc.collect()
    return launches


EXPORT_SAMPLES = 100          # [13a] calibration rows (the reference's default)
EXPORT_BUDGET = 0.1           # [13a] max |d action| of the int8 actor (the reference's budget)
MICRO_INFERENCES = 2000       # [13a] MicroActor calls timed on the host
POP_CHECK = dict(num_agents=3, envs_per_agent=16, rollout_steps=8)   # [13b] card vs CPU
POP_ITERS = 2                 # [13b] iterations at PopulationConfig's defaults
SAFETY_ROWS = 4096            # [13c]
SAFETY_BAR = dict(atol=1e-5, rtol=1e-5)


def native_fingerprint() -> dict:
    """Size, mtime and hash of every file under ``native/``."""
    return {p.name: (p.stat().st_size, p.stat().st_mtime_ns,
                     hashlib.sha256(p.read_bytes()).hexdigest())
            for p in sorted((ROOT / "native").iterdir())}


def export_trained_actor(scratch: Path, dev, n_obs: int, native_before: dict) -> int:
    """[13a]: [9]'s trained default actor through the native int8 export:
    the calibration rollout card vs CPU on the same draws, the ``.tvcq``
    from the card's weights against the CPU copy's, the runtime built with
    g++ into ``tvc_ai_torch/build/``, the int8 actions against the card's
    float deterministic actor, the C artifacts. Returns the rollout's K1
    launches."""
    sac_cfg = build_sac_config(load_config(default_config_path()))
    ckpt = scratch / "run1" / "checkpoints"
    card, host_agent = (load_agent_state(ckpt, n_obs, 2, sac_cfg, where) for where in (dev, "cpu"))
    actor = card.actor
    assert actor.hidden_dims == (256, 256) and actor.mean_head.weight.device == dev, actor
    export_params = RocketConfig().to_env_params(
        domain_randomization=False, sensor_noise=False, max_episode_steps=1000)
    n, steps = calibration_shape(EXPORT_SAMPLES)
    cpu, gen = torch.device("cpu"), torch.Generator().manual_seed(SEED + 60)
    draws = CalibrationDraws(
        reset=rocket_env.draw_reset(export_params, n, cpu, gen),
        actions=[randomization.draw_uniform((n, 2), cpu, gen) for _ in range(steps)],
        steps=[StepDraws(reset=rocket_env.draw_reset(export_params, n, cpu, gen))
               for _ in range(steps)])
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    calib = collect_representative_obs(None, export_params, EXPORT_SAMPLES, n_obs, device=dev,
                                       draws=to_device(draws, dev))
    calib_s = time.perf_counter() - t0
    launches = k1.step_kernel.launches
    host = collect_representative_obs(None, export_params, EXPORT_SAMPLES, n_obs, device="cpu",
                                      draws=draws)
    assert launches == k1.step_kernel.launches == steps, (launches, steps)
    assert calib.shape == (EXPORT_SAMPLES, n_obs), calib.shape
    torch.testing.assert_close(torch.from_numpy(calib), torch.from_numpy(host), **OBS)

    t0 = time.perf_counter()
    lib = build_runtime()
    build_first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert build_runtime() == lib
    build_cached_s = time.perf_counter() - t0
    assert lib.parent == ROOT / "tvc_ai_torch" / "build", lib
    out = scratch / "export"
    path = export_micro(actor, calib, out)
    model = path.read_bytes()
    assert model == quantize_actor(host_agent.actor, calib), (
        "the .tvcq from the card's weights differs from the CPU copy's")
    micro = MicroActor(model, lib)
    assert (micro.input_dim, micro.output_dim) == (n_obs, 2)
    int8 = micro(calib)
    float_actions = sac.select_action(actor, torch.from_numpy(calib).to(dev),
                                      deterministic=True).cpu().numpy()
    diff = np.abs(int8 - float_actions)
    if not diff.max() <= EXPORT_BUDGET:
        raise AssertionError(f"int8 export parity {diff.max():.4f} above {EXPORT_BUDGET}")
    micro_us = benchmark_latency(micro, calib, n=MICRO_INFERENCES)
    cc, h = generate_c_array(model, out, name="tvc_actor")
    example = generate_tflm_example(out, obs_dim=n_obs, action_dim=2)
    for f in (cc, h, example):
        assert f.stat().st_size > 0, f
    assert native_fingerprint() == native_before, "native/ changed"
    git = (subprocess.run(["git", "status", "--porcelain", "native/"], cwd=ROOT,
                          capture_output=True, text=True, check=True).stdout
           if (ROOT / ".git").exists() and shutil.which("git") else None)
    assert not git, git
    log(f"[13a] export of [9]'s trained {actor.hidden_dims} actor (obs {n_obs}): calibration "
        f"rollout {n} envs x {steps} step(s) in {calib_s:.4f} s, card (K1) vs CPU (plain) max "
        f"|d obs| {float(np.abs(calib - host).max()):.3e} (atol {OBS['atol']}, rtol "
        f"{OBS['rtol']}), K1 launches {launches}; {path.name} {len(model)} B, equal to the CPU "
        f"copy's bytes; g++ build {build_first_s:.3f} s first use, {build_cached_s * 1e3:.3f} ms "
        f"cached ({lib.name}); int8 vs the card's float actor over {len(calib)} rows: max |d a| "
        f"{diff.max():.5f} (budget {EXPORT_BUDGET}), mean {diff.mean():.5f}; MicroActor "
        f"{micro_us:.2f} us per inference on the host; C artifacts {cc.name} "
        f"({cc.stat().st_size} B), {h.name}, {example.name}: ok")
    log(f"[13a] native/ unchanged ({len(native_before)} files: size, mtime, sha256); git status "
        f"--porcelain native/: "
        + ("not run (not a git checkout)" if git is None else repr(git)))
    micro.close()
    return launches


def population_card_vs_cpu(dev, short: EnvParams) -> None:
    """[13b]: one population iteration (3 agents x 16 envs x 8 steps,
    updates from step 4) card against CPU from the same weights and draws,
    then ``clone_winners`` on both."""
    pcfg = PopulationConfig(**POP_CHECK)
    n, steps = pcfg.envs_per_agent, pcfg.rollout_steps
    sac_cfg = sac.SACConfig(**dict(DEFAULT_SAC, buffer_size=32 * n, learning_starts=4 * n))
    gen = torch.Generator().manual_seed(SEED + 70)
    per_agent = [learner_draws(short, n, steps, sac_cfg, gen) for _ in range(pcfg.num_agents)]
    out = {}
    for where in ("cpu", dev):
        k1.step_kernel.launches = 0
        carries = init_population(short, sac_cfg, pcfg, device=where, seed=SEED + 70,
                                  reset_draws=[to_device(r, where) for r, _ in per_agent])
        carries, metrics = make_population_iteration(sac_cfg, pcfg)(
            carries, short, [to_device(d, where) for _, d in per_agent])
        out[where] = (carries, metrics, k1.step_kernel.launches)
    torch.cuda.synchronize()
    (a, am, a_launches), (b, bm, b_launches) = out[dev], out["cpu"]
    assert (a_launches, b_launches) == (pcfg.num_agents * steps, 0), (a_launches, b_launches)
    param_err = 0.0
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.agent.step == y.agent.step == steps - 3, (i, x.agent.step, y.agent.step)
        torch.testing.assert_close(x.obs.cpu(), y.obs, **OBS)
        for name in ("episodes", "ep_length", "ep_ring_seq"):
            assert torch.equal(getattr(x, name).cpu(), getattr(y, name)), f"agent {i} {name}"
        for net in ("actor", "critic", "target_critic"):
            param_err = max(param_err, net_param_err(getattr(x.agent, net), getattr(y.agent, net),
                                                     f"agent {i} {net}"))
    for k in bm:
        torch.testing.assert_close(am[k].cpu(), bm[k], **METRICS, msg=k)
    ra, rb = population_returns(a), population_returns(b)
    torch.testing.assert_close(ra.cpu(), rb, **REWARD)
    order = torch.argsort(rb, stable=True).tolist()
    assert torch.argsort(ra, stable=True).tolist() == order, (ra, rb)
    pick = torch.randint(0, 1, (1,), generator=gen)
    ca, cb = clone_winners(a, pick=pick), clone_winners(b, pick=pick)
    loser, winner = order[0], order[-1]
    for cloned, src in ((ca, a), (cb, b)):
        assert not diff_states(cloned[loser].agent, src[winner].agent), "clone differs"
        assert cloned[loser].agent.actor is not src[winner].agent.actor
    log(f"[13b] population {pcfg.num_agents} agents x {n} envs x {steps} steps, card (K1) vs "
        f"CPU (plain): max |d param| {param_err:.3e} (atol {PARAMS['atol']}), returns "
        f"{[round(float(r), 4) for r in rb]} (order {order}), clone_winners: agent {loser} "
        f"holds a copy of agent {winner}'s state, bit for bit on both; K1 launches {a_launches}: "
        "ok")


def run_population(dev, env_params: EnvParams) -> int:
    """[13b]: ``PopulationConfig``'s defaults (4 agents x 128 envs, 64 steps, 1
    update per step) with the default SAC widths for two iterations, a clone,
    one profiled population learning step. Returns the iterations' K1
    launches."""
    sac_cfg = sac.SACConfig(**DEFAULT_SAC)
    pcfg = PopulationConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # what earlier phases still hold
    carries = init_population(env_params, sac_cfg, pcfg, device=dev, seed=SEED + 71)
    it = make_population_iteration(sac_cfg, pcfg)
    k1.step_kernel.launches = 0
    iter_s, updates = [], []
    for _ in range(POP_ITERS):
        before = sum(c.agent.step for c in carries)
        t0 = time.perf_counter()
        carries, metrics = it(carries, env_params)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t0)
        updates.append(sum(c.agent.step for c in carries) - before)
    launches = k1.step_kernel.launches
    env_steps = pcfg.num_agents * pcfg.rollout_steps
    assert launches == POP_ITERS * env_steps, (launches, POP_ITERS * env_steps)
    assert updates[-1] == env_steps and 0 < updates[0] < env_steps, updates
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values()), metrics
    peak = torch.cuda.max_memory_allocated()
    replay_bytes = sum(t.numel() * t.element_size() for c in carries
                       for t in c.buffer.data.values())
    returns = population_returns(carries)
    cloned = clone_winners(carries, generator=torch.Generator().manual_seed(SEED + 72))
    order = torch.argsort(returns, stable=True).tolist()
    assert not diff_states(cloned[order[0]].agent, carries[order[-1]].agent)
    one = make_population_iteration(sac_cfg, dataclasses.replace(pcfg, rollout_steps=1))
    cloned, _ = one(cloned, env_params)   # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cloned, _ = one(cloned, env_params)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    device_breakdown(prof, 1, step_ms, "[13b]",
                     f"profiled population learning step ({pcfg.num_agents} agents x "
                     f"{pcfg.envs_per_agent} envs, 1 update each)", top=8)
    del prof
    n_envs = pcfg.num_agents * pcfg.envs_per_agent
    log(f"[13b] population at PopulationConfig's defaults ({pcfg.num_agents} agents x "
        f"{pcfg.envs_per_agent} envs x {pcfg.rollout_steps} steps, default SAC widths, batch "
        f"{sac_cfg.batch_size}, replay {carries[0].buffer.capacity} rows per agent): "
        + ", ".join(f"{s:.4f} s" for s in iter_s) + " per iteration = "
        + ", ".join(f"{n_envs * pcfg.rollout_steps / s:.1f}" for s in iter_s)
        + " env steps/s, " + ", ".join(f"{u / s:.1f}" for u, s in zip(updates, iter_s))
        + f" updates/s ({updates} updates; learning_starts {sac_cfg.learning_starts}); peak "
        f"device memory {peak / 1e6:.1f} MB, {(peak - held) / 1e6:.1f} MB above the "
        f"{held / 1e6:.1f} MB earlier phases hold, with {replay_bytes / 1e6:.1f} MB of "
        f"replays; K1 "
        f"launches {launches} = {launches // (POP_ITERS * pcfg.rollout_steps)} per population "
        f"env step; returns {[round(float(r), 3) for r in returns]}, clone: agent {order[0]} "
        f"<- agent {order[-1]}: ok")
    return launches


def safety_card_vs_cpu(dev, n_obs: int) -> None:
    """[13c]: ``SafetyCorrectionNet`` forward and ``correction_loss``'s
    gradient at 4096 rows, card against CPU from the same weights; device and
    host ms per forward + backward."""
    gen = torch.Generator().manual_seed(SEED + 80)
    obs = torch.randn((SAFETY_ROWS, n_obs), generator=gen)
    obs[:, :4] = obs[:, :4] / obs[:, :4].norm(dim=-1, keepdim=True)
    obs[: SAFETY_ROWS // 2, :4] = torch.tensor([0.0, 0.0, 0.0, 1.0]) + 0.05 * torch.randn(
        (SAFETY_ROWS // 2, 4), generator=gen)
    obs[:, 4:7] *= 3.0
    act = torch.rand((SAFETY_ROWS, 2), generator=gen) * 2.4 - 1.2
    c = SafetyConstraints()
    res = {}
    for where in ("cpu", dev):
        net = SafetyCorrectionNet(obs_dim=n_obs, device=where, seed=SEED)
        o, a = obs.to(where), act.to(where)
        out = net(o, a)
        loss = correction_loss(net, o, a, c)
        res[where] = (net, o, a, out.detach(), loss.detach(),
                      torch.autograd.grad(loss, list(net.parameters())))
    torch.cuda.synchronize()
    (net, o, a, out, loss, grads), (_, _, _, h_out, h_loss, h_grads) = res[dev], res["cpu"]
    torch.testing.assert_close(out.cpu(), h_out, **SAFETY_BAR)
    torch.testing.assert_close(loss.cpu(), h_loss, **SAFETY_BAR)
    for (name, _), g, h in zip(net.named_parameters(), grads, h_grads):
        torch.testing.assert_close(g.cpu(), h, **SAFETY_BAR, msg=name)
    grad_err = max(float((g.cpu() - h).abs().max()) for g, h in zip(grads, h_grads))
    violated = float(violations(obs, act, c).float().mean())
    params = list(net.parameters())

    def step():
        return torch.autograd.grad(correction_loss(net, o, a, c), params)

    fwd_bwd_ms = device_ms(step, reps=30, inner=5)
    fwd_bwd_host_ms = host_us(step, reps=9, inner=10) / 1e3
    log(f"[13c] SafetyCorrectionNet at {SAFETY_ROWS} rows ({violated:.1%} violate), card vs "
        f"CPU: max |d out| {float((out.cpu() - h_out).abs().max()):.3e}, |d loss| "
        f"{float((loss.cpu() - h_loss).abs()):.3e}, max |d grad| {grad_err:.3e} (atol "
        f"{SAFETY_BAR['atol']}, rtol {SAFETY_BAR['rtol']}); forward + correction_loss "
        f"gradient: device {fwd_bwd_ms:.4f} ms, host {fwd_bwd_host_ms:.4f} ms per call: ok")


# ---------------------------------------------------------------- 14. data parallel
DP_WORLD = 2
DP_N, DP_STEPS = 256, 16       # [14a] global envs (128 a rank), steps: two 8-step episodes
DP_ENS_STEPS = 8               # [14a] ensemble steps (one episode)
DP_PPO_EPOCHS = 2              # [14a] PPO epochs held card vs CPU
DP_JOIN = 420                  # [14a], [14b] seconds the spawned ranks may take
WARM_STEPS = 16                # [14b] a warm-up iteration's steps before the timed one
AR_CALLS = 20                  # [14b] all-reduces timed
TORCHRUN_STEPS = 32            # [14b] the torchrun run's rollout_steps, cut from 128
DP_LEARNERS = ("agent.", "sac.", "td3.", "ppo.")
DP_ENV = dict(randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True))


def dp_check_configs():
    """[14a]: [7]'s widths (256x256 nets, batch 256) at 256 envs (128 a rank)
    in 8-step episodes; the gate opens at the fourth step, the 64-slot ring
    overflows at the first episode end; the ensemble's gate at its second."""
    params = EnvParams(**DP_ENV, max_episode_steps=8)
    sac_cfg = sac.SACConfig(**dict(DEFAULT_SAC, buffer_size=32 * DP_N,
                                   learning_starts=4 * DP_N))
    loop_cfg = loop.TrainLoopConfig(**dict(DEFAULT_LOOP, num_envs=DP_N, rollout_steps=DP_STEPS,
                                           episode_ring_size=64))
    ens_cfg = ensemble.EnsembleConfig(
        sac=dataclasses.replace(sac_cfg, buffer_size=DP_N * DP_ENS_STEPS,
                                learning_starts=2 * DP_N),
        td3=td3.TD3Config(), ppo=ppo.PPOConfig(n_epochs=DP_PPO_EPOCHS))
    return params, sac_cfg, loop_cfg, ens_cfg


def cpu_flat(obj) -> dict:
    """``flat_state(obj)`` with every tensor on the host."""
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
            for k, v in flat_state(obj).items()}


def dp_check_rank(rank: int, dev, root: Path, side: str) -> None:
    """[14a] on one rank: ``make_sharded_train`` for one iteration and
    ``make_sharded_ensemble_train`` with sac and with ppo acting, each from
    ``init_fn`` on the rank's draws (made on the CPU from the rank's seed, so
    the card's rank and the CPU's rank of one index draw alike)."""
    params, sac_cfg, loop_cfg, ens_cfg = dp_check_configs()
    local_sac, local_loop = mesh.local_configs(sac_cfg, loop_cfg, DP_WORLD)
    n = local_loop.num_envs
    gen = torch.Generator().manual_seed(SEED + 40 + rank)
    reset_draws, draws = learner_draws(params, n, DP_STEPS, local_sac, gen)
    init_fn, train_fn = mesh.make_sharded_train(params, sac_cfg, loop_cfg, dev)
    carry = init_fn(SEED, reset_draws=to_device(reset_draws, dev))
    k1.step_kernel.launches = 0
    carry, metrics = train_fn(carry, params, to_device(draws, dev))
    out = {"loop": cpu_flat(dataclasses.replace(carry, generator=None)),
           "loop_metrics": {k: v.cpu() for k, v in metrics.items()},
           "launches": {"loop": k1.step_kernel.launches}}
    local_ens, n_ens = mesh.local_ensemble_config(ens_cfg, DP_N, DP_WORLD)
    init_e, train_fns = mesh.make_sharded_ensemble_train(params, ens_cfg, DP_N, DP_ENS_STEPS, 1,
                                                         dev)
    cpu = torch.device("cpu")
    for actor in ("sac", "ppo"):
        reset_draws = rocket_env.draw_reset(params, n_ens, cpu, gen)
        e_draws = ensemble_draws(actor, local_ens, params, gen, n_ens, DP_ENS_STEPS)
        perms = [torch.randperm(DP_ENS_STEPS * n_ens, generator=gen) for _ in range(DP_PPO_EPOCHS)]
        carry = init_e(SEED, reset_draws=to_device(reset_draws, dev))
        k1.step_kernel.launches = 0
        carry, metrics = train_fns[actor](carry, ENS_WEIGHTS, params, to_device(e_draws, dev),
                                          to_device(perms, dev) if actor == "ppo" else None)
        out[f"ens_{actor}"] = cpu_flat(dataclasses.replace(carry, generator=None))
        out[f"ens_{actor}_metrics"] = {k: v.cpu() for k, v in metrics.items()}
        out["launches"][f"ens_{actor}"] = k1.step_kernel.launches
    torch.save(out, root / f"{side}{rank}.pt")


def full_configs():
    """The default configuration as [8] builds it: 4096 envs x 128 steps,
    256x256 nets, batch 256, a ~1M-row replay."""
    params = EnvParams(**DP_ENV)
    return (params, sac.SACConfig(**DEFAULT_SAC),
            loop.TrainLoopConfig(**DEFAULT_LOOP, obs_dim=obs_dim(params)))


def timed_iteration(carry, warm, train_fn, params, dev) -> tuple[object, dict]:
    """A WARM_STEPS warm-up iteration (``warm``; none when None), then one
    timed iteration of ``train_fn``: its seconds, updates, all-reduces and
    K1 launches."""
    if warm is not None:
        carry, _ = warm(carry, params)
    torch.cuda.synchronize(dev)
    mesh.barrier()
    mesh.counts["all_reduce"] = 0
    k1.step_kernel.launches = 0
    step0 = carry.agent.step
    t0 = time.perf_counter()
    carry, metrics = train_fn(carry, params)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    assert all(math.isfinite(float(v)) for v in metrics.values()), metrics
    return carry, {"s": [secs], "updates": carry.agent.step - step0,
                   "all_reduces": mesh.counts["all_reduce"],
                   "launches": k1.step_kernel.launches}


def dp_full_rank(rank: int, dev, root: Path, side: str) -> None:
    """[14b] world 2 on one rank (gloo, both ranks on the one card): one
    default-config iteration of the rank's 2048 envs, timed; then the wall
    milliseconds of an all-reduce of the critic's gradient size."""
    params, sac_cfg, loop_cfg = full_configs()
    init_fn, train_fn = mesh.make_sharded_train(params, sac_cfg, loop_cfg, dev)
    local_sac, local_loop = mesh.local_configs(sac_cfg, loop_cfg, DP_WORLD)
    warm = loop.make_train_iteration(
        local_sac, dataclasses.replace(local_loop, rollout_steps=WARM_STEPS), mesh.DATA_AXIS)
    carry, out = timed_iteration(init_fn(SEED), warm, train_fn, params, dev)
    grads = [torch.ones_like(p) for p in carry.agent.critic.parameters()]
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(AR_CALLS):
        mesh.sum_grads_(grads, mesh.DATA_AXIS)
    torch.cuda.synchronize(dev)
    out["ar_ms"] = (time.perf_counter() - t0) / AR_CALLS * 1e3
    out.update(envs=carry.obs.shape[0], steps=loop_cfg.rollout_steps,
               global_envs=loop_cfg.num_envs)
    torch.save(out, root / f"{side}{rank}.pt")


def _dp_worker(index: int, job: str, root: str) -> None:
    """A spawned rank: "check" runs [14a] (ranks 0-1 on the card, 2-3 on the
    CPU, two gloo groups), "full" [14b]'s world 2 (both ranks on the card);
    "nccl_check" and "nccl_full" run the same on NCCL, rank r on cuda:r
    ([14c]); "orbax_mesh" [22]'s world 2 (both ranks on the card)."""
    nccl = job.startswith("nccl")
    side = "cuda" if job != "check" or index < DP_WORLD else "cpu"
    rank = index % DP_WORLD
    torch.set_num_threads(2)
    dev = mesh.init_data_parallel(side, backend="nccl" if nccl else "gloo",
                                  init_method=f"file://{root}/rv-{side}", rank=rank,
                                  world_size=DP_WORLD, local_rank=rank if nccl else 0)
    set_parity_precision()
    run = {"check": dp_check_rank, "nccl_check": dp_check_rank,
           "orbax_mesh": orbax_mesh_rank}.get(job, dp_full_rank)
    run(rank, dev, Path(root), side)
    mesh.barrier()
    torch.distributed.destroy_process_group()


def run_ranks(job: str, nprocs: int, root: Path) -> None:
    """Spawn ``nprocs`` ranks of ``job`` and join them within DP_JOIN
    seconds; a rank's exception or a hang fails the phase."""
    root.mkdir(parents=True)
    ctx = torch.multiprocessing.start_processes(_dp_worker, args=(job, str(root)),
                                                nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + DP_JOIN
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"[{job}] ranks did not finish in {DP_JOIN} s")


def dp_bar(path: str, value):
    """The card-vs-CPU bar of a ``flat_state`` path: None for exact, False
    for not held (optimizer moments: the parameters are held)."""
    if not isinstance(value, torch.Tensor) or not value.is_floating_point():
        return None
    if path.startswith(DP_LEARNERS):
        return PARAMS if ("__module_state__" in path or path.endswith("log_alpha")) else False
    if path.endswith(".done") or "ring_success" in path or "ring_length" in path:
        return None
    if any(k in path for k in ("reward", "return", "length_sum")):
        return REWARD
    return OBS


FLIP_SHARE = 1e-4    # [14a]: the share of a tensor's elements an Adam sign flip may move
MAX_ADAM_STEP = 3.2  # the most one Adam step moves an element, in learning rates
MAX_LR = 3e-4        # the largest learning rate [14a]'s members use (alpha's)


def adam_flips(got: torch.Tensor, want: torch.Tensor, updates: int, what: str):
    """Hold a parameter card vs CPU at PARAMS, except for the few elements
    (at most FLIP_SHARE of the tensor, at least one) where an Adam step
    turned the other way: a ReLU unit active on one side and not on the
    other, or a gradient within float32 rounding of zero, whose normalized
    step then has the other sign. Those stay within the most the updates
    could move them. Returns (elements beyond PARAMS, largest difference)."""
    d = (got - want).abs()
    over = int((d > PARAMS["atol"]).sum())
    d_max = float(d.max()) if d.numel() else 0.0
    bound = MAX_ADAM_STEP * MAX_LR * max(updates, 1)
    assert over <= max(1, int(want.numel() * FLIP_SHARE)), (what, over, want.numel(), d_max)
    assert d_max <= bound, (what, d_max, bound)
    return over, d_max


def dp_card_vs_cpu(scratch: Path) -> dict:
    """[14a]: two gloo ranks on the card (K1) and two on the CPU (plain),
    the same draws rank for rank: ``make_sharded_train`` for one iteration
    and ``make_sharded_ensemble_train`` with sac and ppo acting. Holds each
    rank's parameters card vs CPU (1e-4), its env shard, replay and
    counters at the env bars, and on each side the replicas bit for bit
    across the ranks. Returns the card ranks' K1 launches by path."""
    root = scratch / "dp14a"
    t0 = time.perf_counter()
    run_ranks("check", 2 * DP_WORLD, root)
    spawn_s = time.perf_counter() - t0
    out = {(side, r): torch.load(root / f"{side}{r}.pt", weights_only=False)
           for side in ("cuda", "cpu") for r in range(DP_WORLD)}
    worst, flipped, elements = 0.0, {}, 0
    for key in ("loop", "ens_sac", "ens_ppo"):
        updates = max(v for p, v in out["cpu", 0][key].items() if p.endswith(".step")
                      and isinstance(v, int))
        for r in range(DP_WORLD):
            a, b = out["cuda", r][key], out["cpu", r][key]
            assert sorted(a) == sorted(b), key
            for path, want in b.items():
                bar = dp_bar(path, want)
                if bar is False:
                    continue
                if bar is None:
                    assert (torch.equal(a[path], want) if isinstance(want, torch.Tensor)
                            else a[path] == want), (key, r, path)
                elif path.startswith(DP_LEARNERS):
                    n_over, d_max = adam_flips(a[path], want, updates, f"{key} rank {r} {path}")
                    worst = max(worst, d_max)
                    elements += want.numel()
                    if n_over:
                        flipped[f"{key} rank {r} {path}"] = (n_over, want.numel(), d_max)
                else:
                    torch.testing.assert_close(a[path], want, **bar,
                                               msg=lambda m: f"{key} rank {r} {path}: {m}")
            for k, v in out["cpu", r][f"{key}_metrics"].items():
                torch.testing.assert_close(out["cuda", r][f"{key}_metrics"][k], v, **METRICS,
                                           msg=f"{key} metric {k}")
        for side in ("cuda", "cpu"):
            a, b = out[side, 0][key], out[side, 1][key]
            for path in a:
                if path.startswith(DP_LEARNERS) and isinstance(a[path], torch.Tensor):
                    assert torch.equal(a[path], b[path]), (side, key, path)
            assert not torch.equal(a["env_states.body.pos"], b["env_states.body.pos"]), key
    loop_ = out["cuda", 0]["loop"]
    launches = {key: [out["cuda", r]["launches"][key] for r in range(DP_WORLD)]
                for key in ("loop", "ens_sac", "ens_ppo")}
    assert launches["loop"] == [DP_STEPS] * DP_WORLD, launches
    assert all(out["cpu", r]["launches"][k] == 0 for r in range(DP_WORLD)
               for k in launches), "the CPU ranks launched K1"
    log(f"[14a] data parallel card vs CPU, world {DP_WORLD} on gloo (both card ranks on cuda:0; "
        f"{DP_N} envs, {DP_N // DP_WORLD} a rank, 8-step episodes): make_sharded_train "
        f"{DP_STEPS} steps ({loop_['agent.step']} updates, "
        f"{int(loop_['episodes'].sum())} episode ends on rank 0, ring of 64 overflowed), "
        f"make_sharded_ensemble_train {DP_ENS_STEPS} steps with sac and with ppo acting "
        f"({DP_PPO_EPOCHS} PPO epochs); each rank card vs CPU: max |d param| {worst:.3e}; "
        f"{sum(v[0] for v in flipped.values())} of {elements} parameter elements beyond "
        f"atol {PARAMS['atol']} (an Adam step turned the other way; at most {FLIP_SHARE:g} of "
        f"a tensor, each within {MAX_ADAM_STEP} x {MAX_LR:g} x its updates): {flipped}; env "
        f"shards, obs, replay rows and counters at the env bars; "
        f"replicas bit for bit equal across the ranks on the card and on the CPU: ok; K1 "
        f"launches per card rank {launches}; 4 spawned ranks in {spawn_s:.1f} s")
    return {k: sum(v) for k, v in launches.items()}


def dp_nccl_world2(scratch: Path) -> dict:
    """[14c]: NCCL at world 2 where the host has two GPUs (else it says so
    and returns nothing): [14a]'s sharded loop and ensemble on rank 0 at
    cuda:0 and rank 1 at cuda:1, against [14a]'s gloo ranks on the card on
    the same draws (parameters as [14a] holds them, the rest at the env
    bars; bit-equal tensors counted: two ranks' sums round alike on either
    backend), then [14b]'s default iteration at world 2 on NCCL, timed.
    Returns the K1 launches of each run."""
    gpus = torch.cuda.device_count()
    if gpus < DP_WORLD:
        log(f"[14c] NCCL at world {DP_WORLD} is not checked: this host has {gpus} GPU(s) and "
            f"NCCL needs one per rank")
        return {}
    run_ranks("nccl_check", DP_WORLD, scratch / "dp14c")
    equal = total = 0
    worst = 0.0
    for r in range(DP_WORLD):
        got = torch.load(scratch / "dp14c" / f"cuda{r}.pt", weights_only=False)
        want = torch.load(scratch / "dp14a" / f"cuda{r}.pt", weights_only=False)
        for key in ("loop", "ens_sac", "ens_ppo"):
            a, b = got[key], want[key]
            updates = max(v for p, v in b.items() if p.endswith(".step") and isinstance(v, int))
            for path, ref in b.items():
                bar = dp_bar(path, ref)
                if not isinstance(ref, torch.Tensor) or bar is False:
                    continue
                total += 1
                equal += torch.equal(a[path], ref)
                if bar is None:
                    assert torch.equal(a[path], ref), (key, r, path)
                elif path.startswith(DP_LEARNERS):
                    worst = max(worst, adam_flips(a[path], ref, updates, f"{key} {r} {path}")[1])
                else:
                    torch.testing.assert_close(a[path], ref, **bar,
                                               msg=lambda m: f"{key} rank {r} {path}: {m}")
    launches = {f"nccl_{k}": sum(torch.load(scratch / "dp14c" / f"cuda{r}.pt",
                                            weights_only=False)["launches"][k]
                                 for r in range(DP_WORLD)) for k in ("loop", "ens_sac", "ens_ppo")}
    log(f"[14c] NCCL at world {DP_WORLD} (rank r on cuda:r) against [14a]'s gloo ranks on the "
        f"card, the same draws: max |d param| {worst:.3e}, {equal} of {total} held tensors bit "
        f"for bit equal; the rest at the env bars: ok; K1 launches {launches}")
    run_ranks("nccl_full", DP_WORLD, scratch / "dp14c_full")
    ranks = [torch.load(scratch / "dp14c_full" / f"cuda{r}.pt", weights_only=False)
             for r in range(DP_WORLD)]
    secs, steps = max(r["s"][0] for r in ranks), ranks[0]["steps"]
    log(f"[14c] world {DP_WORLD} on NCCL, default config: {ranks[0]['envs']} envs a rank x "
        f"{steps} steps, {secs:.4f} s per iteration = "
        f"{ranks[0]['global_envs'] * steps / secs:.1f} env steps/s (all ranks), "
        f"{ranks[0]['updates']} updates a rank, "
        f"{ranks[0]['all_reduces'] / max(ranks[0]['updates'], 1):.3f} all-reduces per update; "
        f"{ranks[0]['ar_ms']:.4f} ms of wall per all-reduce of the critic's gradient; K1 "
        f"launches {sum(r['launches'] for r in ranks)}")
    launches["nccl_full"] = sum(r["launches"] for r in ranks)
    return launches


def dp_full_width(scratch: Path, dev) -> dict:
    """[14b]: one default-config iteration three ways, in turns A B C B A:
    unsharded, ``make_sharded_train`` at world 1 on NCCL (this process),
    world 2 on gloo (two spawned ranks on the one card); then ``torchrun
    --nproc-per-node 1 -m tvc_ai_torch.train`` for one 32-step iteration.
    Returns the K1 launches of each way's first timed iteration."""
    params, sac_cfg, loop_cfg = full_configs()
    n, steps = loop_cfg.num_envs, loop_cfg.rollout_steps
    warm_loop = dataclasses.replace(loop_cfg, rollout_steps=WARM_STEPS)
    rows = {}
    # A: unsharded
    plain_fn = loop.make_train_iteration(sac_cfg, loop_cfg)
    plain, rows["unsharded"] = timed_iteration(
        loop.init_carry(params, sac_cfg, loop_cfg, dev, seed=SEED),
        loop.make_train_iteration(sac_cfg, warm_loop), plain_fn, params, dev)
    # B: world 1 on NCCL
    mesh.init_data_parallel(dev, backend="nccl", init_method=f"file://{scratch}/rv-nccl",
                            rank=0, world_size=1, local_rank=dev.index)
    assert torch.distributed.get_backend() == "nccl"
    init_fn, nccl_fn = mesh.make_sharded_train(params, sac_cfg, loop_cfg, dev)
    sharded, rows["world 1 NCCL"] = timed_iteration(
        init_fn(SEED), loop.make_train_iteration(sac_cfg, warm_loop, mesh.DATA_AXIS), nccl_fn,
        params, dev)
    grads = [torch.ones_like(p) for p in sharded.agent.critic.parameters()]
    rows["world 1 NCCL"]["ar_device_ms"] = device_ms(
        lambda: mesh.sum_grads_(grads, mesh.DATA_AXIS), reps=30, inner=20)
    rows["world 1 NCCL"]["ar_host_us"] = host_us(lambda: mesh.sum_grads_(grads, mesh.DATA_AXIS))
    grad_mb = sum(g.numel() * 4 for g in grads) / 1e6
    # C: world 2 on gloo, both ranks on the card
    root = scratch / "dp14b"
    run_ranks("full", DP_WORLD, root)
    ranks = [torch.load(root / f"cuda{r}.pt", weights_only=False) for r in range(DP_WORLD)]
    rows["world 2 gloo"] = dict(ranks[0], s=[max(r["s"][0] for r in ranks)],
                                launches=sum(r["launches"] for r in ranks))
    # B, A again
    sharded, again = timed_iteration(sharded, None, nccl_fn, params, dev)
    rows["world 1 NCCL"]["s"] += again["s"]
    torch.distributed.destroy_process_group()
    plain, again = timed_iteration(plain, None, plain_fn, params, dev)
    rows["unsharded"]["s"] += again["s"]
    rows["unsharded"]["envs"] = rows["world 1 NCCL"]["envs"] = n
    del plain, sharded
    gc.collect()
    for name, row in rows.items():
        per_update = row["all_reduces"] / max(row["updates"], 1)
        ar = (f"device {row['ar_device_ms']:.4f} ms, host {row['ar_host_us']:.1f} us per "
              f"all-reduce of the critic's gradient ({grad_mb:.3f} MB)" if "ar_device_ms" in row
              else f"{row['ar_ms']:.4f} ms of wall per all-reduce of the critic's gradient "
                   f"(staged through the host)" if "ar_ms" in row else "no all-reduce")
        log(f"[14b] {name}: {row['envs']} envs a rank x {steps} steps, "
            + ", ".join(f"{t:.4f}" for t in row["s"]) + " s per iteration = "
            + ", ".join(f"{n * steps / t:.1f}" for t in row["s"])
            + f" env steps/s (all ranks), {row['updates']} updates a rank, {per_update:.3f} "
              f"all-reduces per update; {ar}; K1 launches {row['launches']}")
    assert rows["unsharded"]["all_reduces"] == 0
    assert rows["unsharded"]["launches"] == rows["world 1 NCCL"]["launches"] == steps
    assert rows["world 2 gloo"]["launches"] == DP_WORLD * steps
    # the CLI under torchrun at world 1: one 32-step iteration
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=1",
           "-m", "tvc_ai_torch.train", "--output-dir", str(scratch / "torchrun"),
           f"training.total_timesteps={n * TORCHRUN_STEPS}",
           f"training.rollout_steps={TORCHRUN_STEPS}", "logging.tensorboard=false"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"torchrun exited {proc.returncode}: {proc.stderr[-3000:]}")
    final = json.loads((scratch / "torchrun" / "final_metrics.json").read_text())
    assert final["env_steps"] == n * TORCHRUN_STEPS and final["iterations"] == 1, final
    log(f"[14b] torchrun --standalone --nproc-per-node 1 -m tvc_ai_torch.train (default config, "
        f"rollout_steps {TORCHRUN_STEPS}): exit 0 in {time.perf_counter() - t0:.1f} s, 1 "
        f"iteration, {final['env_steps']} env steps, "
        f"{[l for l in proc.stdout.splitlines() if l.startswith('final:')][-1]}")
    return {name: row["launches"] for name, row in rows.items()}


# ---------------------------------------------------------------- 15. demonstration seeding
DEMO_N, DEMO_STEPS = 64, 32    # [15a] card vs CPU
R4_YAML = "robust_r4.yaml"
R4_ROLLOUT = 16                # [15b] rollout_steps, cut from 128


def r4_config():
    return load_config(default_config_path().parent / R4_YAML,
                       [f"training.rollout_steps={R4_ROLLOUT}", "logging.tensorboard=false"])


def demos_card_vs_cpu(dev) -> float:
    """[15a]: ``design_lqr`` on the host CPU, timed; then
    ``generate_demonstrations`` at 64 envs x 32 steps in ``robust_r4.yaml``'s
    demo env through K1 on the card against the plain route on the CPU, on
    the same draws: obs 5e-5 / 5e-4, reward 1e-3, done exact."""
    params = demo_env_params(r4_config())
    t0 = time.perf_counter()
    design = demos.design_lqr(params)
    design_s = time.perf_counter() - t0
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 50)
    reset_draws = rocket_env.draw_reset(params, DEMO_N, cpu, gen)
    step_draws = [StepDraws(n_imu=torch.randn((DEMO_N, 7), generator=gen),
                            reset=rocket_env.draw_reset(params, DEMO_N, cpu, gen))
                  for _ in range(DEMO_STEPS)]
    out = {}
    for where in ("cpu", "cuda"):
        k1.step_kernel.launches = 0
        out[where] = demos.generate_demonstrations(
            params, design, DEMO_N, DEMO_STEPS, device=where,
            reset_draws=to_device(reset_draws, where), step_draws=to_device(step_draws, where))
        out[where + "_launches"] = k1.step_kernel.launches
    (a, a_stats), (b, b_stats) = out["cuda"], out["cpu"]
    assert out["cuda_launches"] == DEMO_STEPS and out["cpu_launches"] == 0, out
    for k in ("obs", "next_obs", "action"):
        torch.testing.assert_close(a[k].cpu(), b[k], **OBS, msg=k)
    torch.testing.assert_close(a["reward"].cpu(), b["reward"], **REWARD)
    assert torch.equal(a["done"].cpu(), b["done"]), "terminations differ"
    assert a_stats == b_stats, (a_stats, b_stats)
    err = float((a["obs"].cpu() - b["obs"]).abs().max())
    log(f"[15a] design_lqr on the host CPU: {design_s:.3f} s; gains {np.round(design.gain, 4)}, "
        f"z_eq {float(design.z_eq):.5f}, trim slope {float(design.trim_slope):.5f}")
    log(f"[15a] generate_demonstrations {DEMO_N} envs x {DEMO_STEPS} steps ({R4_YAML}'s demo env: "
        f"cg <= {params.randomization.cg_offset_max}, nominal starts, sensor noise, drift obs "
        f"{obs_dim(params)} wide), card (K1) vs CPU (plain): max |d obs| {err:.3e} (atol "
        f"{OBS['atol']}, rtol {OBS['rtol']}), rewards at {REWARD['atol']}, terminations equal "
        f"({int(b_stats['demo_episodes'])} episodes, success "
        f"{b_stats['demo_success_rate']:.3f}); K1 launches {out['cuda_launches']}: ok")
    return err


def run_robust_r4(scratch: Path, dev) -> dict:
    """[15b]: ``Trainer`` on ``robust_r4.yaml`` at its widths (512 envs, 16
    updates of batch 1024 per step, drift obs, demo seeding of 512 envs x
    600 steps with a 25 % demo fraction and BC 2.5) with ``rollout_steps``
    cut from 128 to 16, two iterations and the final eval."""
    cfg = r4_config()
    n = cfg.training.num_envs
    cfg.training.total_timesteps = 2 * n * R4_ROLLOUT
    ds = cfg.training.demo_seeding
    k1.step_kernel.launches = 0
    tr = Trainer(cfg, output_dir=scratch / "robust_r4", device=dev)
    demo_launches = k1.step_kernel.launches
    assert demo_launches == ds.steps, (demo_launches, ds.steps)
    evals: list = []
    counting_evals(tr, evals)
    k1.step_kernel.launches = 0
    result = tr.train()
    launches = k1.step_kernel.launches
    iters = result["iterations"]
    assert iters == 2 and result["env_steps"] == 2 * n * R4_ROLLOUT, result
    assert launches == iters * R4_ROLLOUT + sum(k for k, _, _ in evals), (launches, evals)
    metrics = {k: v for k, v in result.items() if k.startswith("eval_")}
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    train_s = result["stage_timing"]["train_iteration"]["total_sec"]
    per = cfg.training.updates_per_step
    buf, demo = tr.carry.buffer, tr.carry.demo_buffer
    assert demo.size == demo.capacity == ds.steps * ds.envs and tr.loop_cfg.demo_fraction == 0.25

    def mb(b):
        return sum(t.numel() * t.element_size() for t in b.data.values()) / 1e6

    stats = tr.demo_stats
    log(f"[15b] {R4_YAML} ({n} envs, SAC batch {tr.sac_cfg.batch_size} with "
        f"{int(round(tr.sac_cfg.batch_size * tr.loop_cfg.demo_fraction))} demo rows, BC weight "
        f"{tr.sac_cfg.bc_weight}, {per} updates per step, obs {tr.loop_cfg.obs_dim} with drift; "
        f"rollout_steps cut from 128 to {R4_ROLLOUT}, a depth cut): demo seeding "
        f"{tr.demo_seconds:.3f} s for {ds.envs} envs x {ds.steps} steps "
        f"({int(stats['demo_transitions'])} transitions, {int(stats['demo_episodes'])} "
        f"episodes, success {stats['demo_success_rate']:.4f}; the LQR design cached from "
        f"[15a]), K1 launches {demo_launches}; replay {buf.size} of {buf.capacity} rows "
        f"({mb(buf):.1f} MB), demo buffer {demo.size} rows ({mb(demo):.1f} MB)")
    log(f"[15b] {iters} iterations: {result['stage_timing']['train_iteration']['mean_sec']:.4f} s "
        f"per iteration, {tr.carry.agent.step} updates in {train_s:.4f} s = "
        f"{tr.carry.agent.step / train_s:.1f} updates/s; K1 launches {launches} == {iters} x "
        f"{R4_ROLLOUT} + {launches - iters * R4_ROLLOUT} eval steps; final eval: "
        + ", ".join(f"{k} {v:.4g}" for k, v in sorted(metrics.items())
                    if k.endswith(("success_rate", "reward_mean"))))
    tr.logger.close()
    return {"robust_r4_demos": demo_launches, "robust_r4": launches}


# ---------------------------------------------------------------- 16. the distillation chain
DISTILL_OBS = dict(drift_obs_enabled=True, action_obs_enabled=True)
LIBRARY = ROOT / "tvc_ai_torch" / "data" / "ctrl_library_robustness.npz"
SCORE_CRASH = 2e-2           # a crashing CEM candidate's score drift (tests/test_torch_cem.py)
# a parted [16b] draw's best-score drift: a few streak steps and the tilt term,
# 2x the largest over 6 seeds of 64 draws on an H100 (--cem-parting 6); a win is 1000
SCORE_PARTED = 4.0
CEM_CHECK = dict(draws=64, pop=8, elites=4, horizon=160, generations=2)      # [16b] card vs CPU
CEM_SEEDS = (SEED + 61, SEED + 62)   # [16b]: the second has draws that win
CEM_FULL = dict(draws=512, pop=32, horizon=500, generations=2)   # [16b]: generations cut from 15
DAGGER_CHECK = dict(num_envs=64, rollout_steps=16, train_steps=32, batch_size=256)  # [16c]
DAGGER_FULL = dict(num_envs=512, rollout_steps=512, train_steps=1500, batch_size=4096)
# [16c]'s CEM-teacher iteration at 512 draws x 32 pop: generations cut from 15, the
# scoring horizon from 500, the rollout from 512 steps and the minibatches from 1500
CEM_DAGGER_CUT = dict(rollout_steps=64, train_steps=100, generations=2, horizon=200)
# [16d] at 512 draws x 64 pop: generations cut from 25, horizon from 700, rollout
# from 512 steps, minibatches from 1500; the policy's eval horizon from 2000
THETA_CUT = dict(num_envs=512, capacity=1 << 21, rollout_steps=32, train_steps=100, generations=1,
                 horizon=100, eval_steps=256)
CLI_DAGGER = ["--iters", "1", "--envs", "64", "--rollout_steps", "16", "--train_steps", "32",
              "--batch", "1024", "--eval_episodes", "16", "--teacher", "scheduled"]
FT_YAML, FT_ROLLOUT = "robust_student_ft_r5.yaml", 16     # [16e]: rollout_steps cut from 128
FT_EXTRA: list[str] = []   # further overrides (none on the card; a CPU rehearsal shrinks it)
PILOT_CHECK = dict(episodes=8, particles=32, steps=16)      # [16e] card vs CPU
PILOT_CLI = ["--steps", "64", "--select", "25"]            # [16e]: the horizon cut from 2000
HIDDEN_STUDENT = (256, 256)
HISTORY = 8
SCHEDULE = dict(grid=7, rollouts=8, horizon=600)   # [16a]: design_lqr_schedule's defaults


def distill_params() -> EnvParams:
    """``python -m tvc_ai_torch.dagger_distill``'s training env: the
    robustness suite with the drift and action channels, the DR box widened
    by its defaults."""
    return dagger_distill.widened_params(
        _suite_env_params("robustness", obs_overrides=DISTILL_OBS), 0.35, 0.25, 0.06, 3.5)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def schedule_card_vs_cpu(dev) -> tuple[demos.LQRSchedule, int]:
    """[16a]: ``design_lqr_schedule`` at 7 x 7 with verification (49 cells x 4
    variants x 8 rollouts = 1,568 rows x 600 steps) on the card, timed, and
    on the CPU on the same draws: flipped rollouts counted and bounded (2 %
    of the rollouts), the selected variant equal wherever its margin over
    the runner-up exceeds the cell's flips, the selected gains and ``z_eq``
    at rtol 1e-4 there. Returns the card's schedule and its K1 launches."""
    params = distill_params()
    v_params = dataclasses.replace(params, randomization=dataclasses.replace(
        params.randomization, enabled=False, sensor_noise_enabled=False,
        sensor_noise_uniform=False, progress_rate_randomized=False))
    grid, rollouts, horizon = SCHEDULE["grid"], SCHEDULE["rollouts"], SCHEDULE["horizon"]
    cells = grid * grid
    rows = cells * (len(demos._VERIFY_R_SCALES) + 1) * rollouts
    size = dict(n_mass=grid, n_tscale=grid, verify_rollouts=rollouts, verify_horizon=horizon)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 60)
    draws = (rocket_env.draw_reset(v_params, rows, cpu, gen),
             torch.rand(rows, generator=gen) * (2.0 * math.pi))
    t0 = time.perf_counter()
    demos.design_lqr_schedule(params, n_mass=grid, n_tscale=grid, verify=False)
    design_s = time.perf_counter() - t0
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    card = demos.design_lqr_schedule(params, **size, device=dev,
                                     verify_draws=to_device(draws, dev))
    sync(dev)
    card_s = time.perf_counter() - t0
    launches = k1.step_kernel.launches
    assert launches == horizon, launches
    t0 = time.perf_counter()
    ref = demos.design_lqr_schedule(params, **size, device="cpu", verify_draws=draws)
    cpu_s = time.perf_counter() - t0
    vs_a = card.variant_success.reshape(cells, -1).numpy()
    vs_b = ref.variant_success.reshape(cells, -1).numpy()
    cell_flips = np.rint(np.abs(vs_a - vs_b) * rollouts).sum(1)
    flips = int(cell_flips.sum())
    assert flips <= rows // 50, (flips, rows)
    top2 = np.sort(vs_b, 1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) * rollouts > cell_flips
    same = vs_a.argmax(1) == vs_b.argmax(1)
    assert same[decided].all(), np.flatnonzero(decided & ~same)
    torch.testing.assert_close(card.z_eq, ref.z_eq, rtol=1e-4, atol=0.0)
    for name in ("gain", "gain_pitch"):
        a, b = getattr(card, name).reshape(cells, 6), getattr(ref, name).reshape(cells, 6)
        torch.testing.assert_close(a[torch.from_numpy(same)], b[torch.from_numpy(same)],
                                   rtol=1e-4, atol=1e-6, msg=name)
    log(f"[16a] design_lqr_schedule {grid} x {grid} (dagger_distill's training env): "
        f"design {design_s:.3f} s on the host CPU; with verification on the card {card_s:.3f} s "
        f"({card_s - design_s:.3f} s of verification: {rows} rows x {horizon} steps, K1 "
        f"launches {launches}); on the CPU {cpu_s:.3f} s; feasible cells card "
        f"{int(card.feasible.sum())}, CPU {int(ref.feasible.sum())} of {cells}; flipped "
        f"rollouts {flips} of {rows} (bound {rows // 50}); selected variant equal in "
        f"{int(same.sum())} of {cells} cells, {int(decided.sum())} decided beyond their flips: ok")
    return card, launches


def cem_check(dev, sched: demos.LQRSchedule, seed: int) -> dict:
    """``refine_per_draw`` at ``CEM_CHECK`` on the card and on the CPU from the
    same draws (``seed``), compared draw by draw: the CPU's best score
    ("score"), |card − CPU| of it ("d_score"), the draws won on the CPU
    ("won") and where the card's win differs ("win_flip"), the draws whose
    best θ (1e-4) or best score (``SCORE_CRASH``) parts ("parted"), and the
    card's K1 launches ("launches")."""
    params = distill_params()
    c = CEM_CHECK
    cfg = cem.CEMConfig(pop=c["pop"], elites=c["elites"], generations=c["generations"],
                        horizon=c["horizon"])
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(seed)
    reset_draws = rocket_env.draw_reset(params, c["draws"], cpu, gen)
    cem_draws = cem.draw(c["draws"], cfg, cpu, gen)
    out = {}
    for where in (cpu, dev):
        states, _ = rocket_env.reset(params, c["draws"], where,
                                     draws=to_device(reset_draws, where))
        k1.step_kernel.launches = 0
        theta, score = cem.refine_per_draw(
            params, states, cem.theta_for_states(sched, states), cfg,
            draws=to_device(cem_draws, where),
            generator=torch.Generator(device=where).manual_seed(0))
        out[where.type] = (theta.cpu(), score.cpu())
    (th_a, s_a), (th_b, s_b) = out[dev.type], out["cpu"]
    d_score = (s_a - s_b).abs()
    won = s_b >= 0.5 * cfg.success_bonus
    return {"score": s_b, "d_score": d_score, "won": won,
            "win_flip": (s_a >= 0.5 * cfg.success_bonus) != won,
            "parted": ~(((th_a - th_b).abs() <= 1e-4 + 1e-4 * th_b.abs()).all(1)
                        & (d_score <= SCORE_CRASH)),
            "launches": k1.step_kernel.launches}


def cem_card_vs_cpu(dev, sched: demos.LQRSchedule) -> dict:
    """[16b]: ``refine_per_draw`` card vs CPU at 64 draws x 8 pop (4 elites) x
    160 steps (a win needs 100) x 2 generations on the same draws, for each
    of ``CEM_SEEDS``. Every
    draw's win (score ≥ half the success bonus) is equal on both sides. A
    draw is held at best θ 1e-4 and best score ``SCORE_CRASH``; where either
    parts (K1's rounding amplified by a crashing candidate, or elites that
    part on a near-tie) the draw is counted, at most 1 in 8, and its best
    score held at ``SCORE_PARTED``. Then one refinement at ``dagger_distill``'s
    width (512 draws x 32 pop = 16,384 rows, horizon 500), generations cut
    from 15 to 2."""
    params = distill_params()
    c = CEM_CHECK
    check_launches = 0
    for seed in CEM_SEEDS:
        chk = cem_check(dev, sched, seed)
        flips, parted, d_score = chk["win_flip"], chk["parted"], chk["d_score"]
        assert not flips.any(), (seed, np.flatnonzero(flips.numpy()), chk["score"][flips])
        n_parted = int(parted.sum())
        assert n_parted <= c["draws"] // 8, (seed, n_parted, chk["score"][parted], d_score[parted])
        parted_err = float(d_score[parted].max()) if n_parted else 0.0
        assert parted_err <= SCORE_PARTED, (seed, chk["score"][parted], d_score[parted])
        assert chk["launches"] > 0, chk
        check_launches += chk["launches"]
        log(f"[16b] refine_per_draw card vs CPU, seed {seed} ({c['draws']} draws x {c['pop']} "
            f"pop, {c['elites']} elites, {c['horizon']} steps x {c['generations']} generations; "
            f"elites by a stable descending sort, the first of equal scores): wins equal on all "
            f"{c['draws']} draws ({int(chk['won'].sum())} won); best θ equal at 1e-4 and best "
            f"score within {SCORE_CRASH} on {c['draws'] - n_parted} draws (max |d score| "
            f"{float(d_score[~parted].max()):.3e}), {n_parted} parted (bound {c['draws'] // 8}; "
            f"max |d score| {parted_err:.3e}, bound {SCORE_PARTED}); K1 launches "
            f"{chk['launches']}: ok")
    f = CEM_FULL
    cfg = cem.CEMConfig(pop=f["pop"], generations=f["generations"], horizon=f["horizon"])
    gen_d = torch.Generator(device=dev).manual_seed(SEED + 62)
    states, _ = rocket_env.reset(params, f["draws"], dev, generator=gen_d)
    theta0 = cem.theta_for_states(sched, states)
    sync(dev)
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    _, score = cem.refine_per_draw(params, states, theta0, cfg, generator=gen_d)
    solved = float((score >= 0.5 * cfg.success_bonus).float().mean())
    seconds = time.perf_counter() - t0
    launches = k1.step_kernel.launches
    rows = f["draws"] * f["pop"]
    log(f"[16b] refine_per_draw at dagger_distill's width ({f['draws']} draws x {f['pop']} pop = "
        f"{rows} rows, horizon {f['horizon']}; generations cut from 15 to {f['generations']}, a "
        f"depth cut): {seconds:.3f} s, {launches} K1 steps (early exit at the first multiple of "
        f"32 where every row ended), {launches * rows / seconds:.0f} env steps/s, "
        f"{seconds / max(launches, 1) * 1e3:.3f} ms of host per step; solved {solved:.4f}")
    return {"cem_card_vs_cpu": check_launches, "cem_full": launches}


def cem_parting(dev, seeds: int) -> int:
    """``--cem-parting N``: [16b]'s card-vs-CPU check on N seeds of draws,
    each seed's win flips and parted draws printed (what sizes
    ``SCORE_PARTED``)."""
    sched, _ = schedule_card_vs_cpu(dev)
    for seed in range(SEED + 61, SEED + 61 + seeds):
        chk = cem_check(dev, sched, seed)
        parted = chk["parted"]
        log(f"[16b] seed {seed}: {int(chk['won'].sum())} won, {int(chk['win_flip'].sum())} win "
            f"flips, {int(parted.sum())} parted, |d score| of the parted "
            f"{[round(float(x), 4) for x in chk['d_score'][parted]]}, of the rest at most "
            f"{float(chk['d_score'][~parted].max()):.3e}")
    return 0


def dagger_draws(params: EnvParams, n: int, steps: int, train_steps: int, batch: int,
                 gen: torch.Generator, cem_cfg: cem.CEMConfig | None = None):
    """CPU draws of one DAgger iteration (the CEM teacher's too with ``cem_cfg``)."""
    cpu = torch.device("cpu")
    d = dagger.DaggerDraws(
        u_mix=torch.rand((steps, n, 1), generator=gen),
        steps=[StepDraws(n_imu=torch.randn((n, 7), generator=gen),
                         reset=rocket_env.draw_reset(params, n, cpu, gen)) for _ in range(steps)],
        idx=torch.randint(0, n * steps, (train_steps, batch), generator=gen))
    if cem_cfg is not None:
        d.reset = rocket_env.draw_reset(params, n, cpu, gen)
        d.cem = cem.draw(n, cem_cfg, cpu, gen)
        d.u_choice = torch.rand(n, generator=gen)
    return d


def module_flips(a: torch.nn.Module, b: torch.nn.Module, updates: int, what: str):
    """``adam_flips`` over a card module's parameters against the CPU's:
    (elements beyond PARAMS, largest difference)."""
    held = [adam_flips(x.detach().cpu(), y.detach(), updates, f"{what} {name}")
            for (name, x), y in zip(a.named_parameters(), b.parameters())]
    return sum(o for o, _ in held), max(d for _, d in held)


def run_dagger(scratch: Path, dev, sched: demos.LQRSchedule):
    """[16c]: both DAgger teachers card vs CPU at 64 envs x 16 steps and 32
    minibatches on the same draws (student parameters at 1e-4); the scheduled
    teacher at ``dagger_distill``'s full width; the CEM teacher at 512 draws x
    32 pop with its depth cut; ``student.pt`` written; the CLI for one
    iteration. Returns (K1 launches, the student's path, the student)."""
    params = distill_params()
    n_obs = obs_dim(params)
    view = n_obs * HISTORY
    sac_cfg = sac.SACConfig(hidden_dims=HIDDEN_STUDENT)
    cpu = torch.device("cpu")
    c = DAGGER_CHECK
    cfg = dagger.DaggerConfig(num_envs=c["num_envs"], rollout_steps=c["rollout_steps"],
                              capacity=2 * c["num_envs"] * c["rollout_steps"],
                              batch_size=c["batch_size"], train_steps=c["train_steps"],
                              history_len=HISTORY)
    cem_small = cem.CEMConfig(pop=4, elites=2, generations=2, horizon=32)
    gen = torch.Generator().manual_seed(SEED + 63)
    init_draws = rocket_env.draw_reset(params, cfg.num_envs, cpu, gen)
    draws = {kind: dagger_draws(params, cfg.num_envs, cfg.rollout_steps, cfg.train_steps,
                                cfg.batch_size, gen, cem_small if kind == "cem" else None)
             for kind in ("scheduled", "cem")}
    launches = {}
    for kind in ("scheduled", "cem"):
        actors, metrics = {}, {}
        for where in (cpu, dev):
            actor = sac.make_actor(view, 2, sac_cfg, where, seed=1)
            sched_w = sched.to(where)
            rp = params.rocket
            if kind == "scheduled":
                state = dagger.init_state(params, actor, cfg, n_obs, 2, where,
                                          reset_draws=to_device(init_draws, where))
                it = dagger.make_dagger_iteration(
                    params, lambda s: demos.lqr_action_scheduled(
                        s.body, sched_w, s.dr.mass, s.dr.thrust_scale,
                        torch.zeros_like(s.dr.cg_offset), rp), sac_cfg, cfg, n_obs, 2)
            else:
                state = dagger.init_cem_state(actor, cfg, n_obs, 2, where)
                it = dagger.make_cem_dagger_iteration(params, sched_w, sac_cfg, cfg, n_obs, 2,
                                                      cem_small)
            k1.step_kernel.launches = 0
            state, m = it(state, 0.5, to_device(draws[kind], where),
                          torch.Generator(device=where).manual_seed(0))
            launches[f"dagger_{kind}_card_vs_cpu"] = k1.step_kernel.launches
            actors[where.type], metrics[where.type] = state, m
        a, b = actors[dev.type], actors["cpu"]
        over, err = module_flips(a.actor, b.actor, cfg.train_steps, f"{kind} student")
        torch.testing.assert_close(a.data_obs.cpu(), b.data_obs, **OBS)
        for k in metrics["cpu"]:
            torch.testing.assert_close(metrics[dev.type][k].cpu().float(),
                                       metrics["cpu"][k].float(), **METRICS, msg=k)
        log(f"[16c] {kind}-teacher DAgger iteration card vs CPU ({cfg.num_envs} envs x "
            f"{cfg.rollout_steps} steps, history {HISTORY}, {cfg.train_steps} minibatches of "
            f"{cfg.batch_size}, 256x256 student): max |d param| {err:.3e} (atol "
            f"{PARAMS['atol']}; {over} elements beyond it, Adam sign flips, bounded), ring rows "
            f"at the env bars, metrics equal; K1 launches "
            f"{launches[f'dagger_{kind}_card_vs_cpu']}: ok")

    # the scheduled teacher at full width
    f = DAGGER_FULL
    cfg = dagger.DaggerConfig(num_envs=f["num_envs"], rollout_steps=f["rollout_steps"],
                              capacity=8 * f["num_envs"] * f["rollout_steps"],
                              batch_size=f["batch_size"], train_steps=f["train_steps"],
                              history_len=HISTORY)
    gen_d = torch.Generator(device=dev).manual_seed(SEED + 64)
    sched_d = sched.to(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    template = sac.init(view, 2, sac_cfg, dev, seed=SEED)
    state = dagger.init_state(params, template.actor, cfg, n_obs, 2, dev, gen_d)
    rp = params.rocket
    it = dagger.make_dagger_iteration(
        params, lambda s: demos.lqr_action_scheduled(
            s.body, sched_d, s.dr.mass, s.dr.thrust_scale, torch.zeros_like(s.dr.cg_offset), rp),
        sac_cfg, cfg, n_obs, 2)
    sync(dev)
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    roll = it.collect(state, 1.0, None, gen_d)
    sync(dev)
    roll_s = time.perf_counter() - t0
    launches["dagger_full"] = k1.step_kernel.launches
    t0 = time.perf_counter()
    train = it.train(state, None, gen_d)
    sync(dev)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e6
    ring_mb = state.data_obs.numel() * 4 / 1e6
    rows = cfg.num_envs * cfg.rollout_steps
    assert launches["dagger_full"] == cfg.rollout_steps and state.size == rows
    assert math.isfinite(float(train["bc_loss_last"]))
    log(f"[16c] scheduled-teacher iteration at dagger_distill's width ({cfg.num_envs} envs x "
        f"{cfg.rollout_steps} steps = {rows} rows, history {HISTORY} (view {view}), ring "
        f"{cfg.capacity} rows, {cfg.train_steps} minibatches of {cfg.batch_size}): rollout "
        f"{roll_s:.3f} s ({roll_s / cfg.rollout_steps * 1e3:.3f} ms per step, "
        f"{rows / roll_s:.0f} env steps/s), train {train_s:.3f} s ({train_s / cfg.train_steps * 1e3:.3f} "
        f"ms per minibatch), bc {float(train['bc_loss_first']):.5f} -> "
        f"{float(train['bc_loss_last']):.5f}, {int(roll['rollout_episodes'])} episodes ended; "
        f"data_obs {ring_mb:.1f} MB, peak device memory {peak:.1f} MB; K1 launches "
        f"{launches['dagger_full']}")
    student_path = scratch / "dagger_r5" / "student.pt"
    dagger.save_student(student_path, state.actor, sac_cfg, view, 2, SEED)
    student_actor = state.actor
    del state, it, template

    # the CEM teacher at 512 draws x 32 pop, depth cut
    x = CEM_DAGGER_CUT
    cfg = dagger.DaggerConfig(num_envs=f["num_envs"], rollout_steps=x["rollout_steps"],
                              capacity=8 * f["num_envs"] * x["rollout_steps"],
                              batch_size=f["batch_size"], train_steps=x["train_steps"],
                              history_len=HISTORY)
    ccfg = cem.CEMConfig(pop=32, generations=x["generations"], horizon=x["horizon"])
    state = dagger.init_cem_state(sac.make_actor(view, 2, sac_cfg, dev, seed=2), cfg, n_obs, 2,
                                  dev)
    it = dagger.make_cem_dagger_iteration(params, sched, sac_cfg, cfg, n_obs, 2, ccfg)
    sync(dev)
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    state, m = it(state, 1.0, generator=gen_d)
    sync(dev)
    seconds = time.perf_counter() - t0
    launches["dagger_cem"] = k1.step_kernel.launches
    log(f"[16c] CEM-teacher iteration ({cfg.num_envs} draws x {ccfg.pop} pop = "
        f"{cfg.num_envs * ccfg.pop} scoring rows; cut: generations 15 -> {ccfg.generations}, "
        f"scoring horizon 500 -> {ccfg.horizon}, rollout 512 -> {cfg.rollout_steps} steps, "
        f"minibatches 1500 -> {cfg.train_steps}): {seconds:.3f} s, teacher solved "
        f"{float(m['teacher_solved']):.4f}, labelled rows {float(m['labeled_rows']):.0f}; K1 "
        f"launches {launches['dagger_cem']}")
    del state, it

    # the command-line module, one cut iteration, in process
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    rc = dagger_distill.main(["--out", str(scratch / "dagger_cli"), *CLI_DAGGER])
    assert rc == 0 and (scratch / "dagger_cli" / "student.pt").exists(), rc
    launches["dagger_cli"] = k1.step_kernel.launches
    log(f"[16c] python -m tvc_ai_torch.dagger_distill {' '.join(CLI_DAGGER)}: exit 0 in "
        f"{time.perf_counter() - t0:.3f} s, K1 launches {launches['dagger_cli']}; student.pt "
        f"written ({student_path.stat().st_size} B from the full-width iteration)")
    return launches, student_path, student_actor


def run_theta(dev, sched: demos.LQRSchedule) -> dict:
    """[16d]: ``theta_hat_action`` card vs CPU at 1e-5 and one small θ-DAgger
    iteration at 1e-4; one iteration at 512 draws x 64 pop with its depth
    cut; ``make_theta_policy_fn`` through ``make_policy_eval_fn`` on 512
    robustness episodes, the horizon cut."""
    params = distill_params()
    n_obs = obs_dim(params)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 65)
    _, obs = rocket_env.reset(params, 512, cpu, generator=gen)
    theta10 = torch.randn((512, 10), generator=gen) * 2.0
    a = theta_student.theta_hat_action(theta10.to(dev), obs.to(dev), params).cpu()
    b = theta_student.theta_hat_action(theta10, obs, params)
    torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    launches = {}
    cfg = theta_student.ThetaDaggerConfig(num_envs=64, rollout_steps=16, capacity=2048,
                                          batch_size=256, train_steps=32, history_len=HISTORY)
    cem_small = cem.CEMConfig(pop=4, elites=2, generations=2, horizon=32)
    draws = dagger_draws(params, cfg.num_envs, cfg.rollout_steps, cfg.train_steps,
                         cfg.batch_size, gen, cem_small)
    states = {}
    for where in (cpu, dev):
        state = theta_student.init_theta_state(cfg, n_obs, where, seed=3)
        it = theta_student.make_theta_dagger_iteration(params, sched, cfg, n_obs, cem_small)
        k1.step_kernel.launches = 0
        state, _ = it(state, 0.5, to_device(draws, where),
                      torch.Generator(device=where).manual_seed(0))
        launches["theta_card_vs_cpu"] = k1.step_kernel.launches
        states[where.type] = state
    over, err = module_flips(states[dev.type].net, states["cpu"].net, cfg.train_steps, "θ-net")
    torch.testing.assert_close(states[dev.type].data_theta.cpu(), states["cpu"].data_theta,
                               atol=1e-5, rtol=1e-5)
    log(f"[16d] theta_hat_action card vs CPU at 512 frames: max |d a| "
        f"{float((a - b).abs().max()):.3e} (1e-5); θ-DAgger iteration card vs CPU (64 envs x 16 "
        f"steps, 32 minibatches): max |d param| {err:.3e} (atol {PARAMS['atol']}; {over} "
        f"elements beyond it, Adam sign flips, bounded); K1 launches "
        f"{launches['theta_card_vs_cpu']}: ok")
    x = THETA_CUT
    cfg = theta_student.ThetaDaggerConfig(num_envs=x["num_envs"], capacity=x["capacity"],
                                          rollout_steps=x["rollout_steps"],
                                          train_steps=x["train_steps"])
    ccfg = cem.CEMConfig(pop=64, generations=x["generations"], horizon=x["horizon"])
    gen_d = torch.Generator(device=dev).manual_seed(SEED + 66)
    state = theta_student.init_theta_state(cfg, n_obs, dev, seed=SEED)
    it = theta_student.make_theta_dagger_iteration(params, sched, cfg, n_obs, ccfg)
    sync(dev)
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    state, m = it(state, 1.0, generator=gen_d)
    sync(dev)
    seconds = time.perf_counter() - t0
    launches["theta_full"] = k1.step_kernel.launches
    log(f"[16d] θ-DAgger iteration ({cfg.num_envs} draws x {ccfg.pop} pop = "
        f"{cfg.num_envs * ccfg.pop} scoring rows, ring {cfg.capacity} rows of view "
        f"{n_obs * cfg.history_len}; cut: generations 25 -> {ccfg.generations}, horizon 700 -> "
        f"{ccfg.horizon}, rollout 512 -> {cfg.rollout_steps}, minibatches 1500 -> "
        f"{cfg.train_steps}): {seconds:.3f} s, teacher solved {float(m['teacher_solved']):.4f}, "
        f"θ loss {float(m['theta_loss_first']):.4f} -> {float(m['theta_loss_last']):.4f}; K1 "
        f"launches {launches['theta_full']}")
    eval_params = dataclasses.replace(_suite_env_params("robustness", obs_overrides=DISTILL_OBS),
                                      max_episode_steps=x["eval_steps"])
    eval_fn = make_policy_eval_fn(theta_student.make_theta_policy_fn(eval_params, cfg), 512,
                                  history_len=cfg.history_len)
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    stats = eval_fn(state.net, torch.Generator(device=dev).manual_seed(SEED), eval_params)
    success = float(stats.success.float().mean())
    seconds = time.perf_counter() - t0
    launches["theta_eval"] = k1.step_kernel.launches
    assert torch.isfinite(stats.returns).all()
    log(f"[16d] make_theta_policy_fn through make_policy_eval_fn: 512 robustness episodes "
        f"(horizon cut from 2000 to {x['eval_steps']}): {seconds:.3f} s, "
        f"{launches['theta_eval']} steps run, success {success:.4f}, mean length "
        f"{float(stats.lengths.float().mean()):.1f}")
    return launches


def run_student_finetune(scratch: Path, dev, student_path: Path, student) -> int:
    """[16e]: ``robust_student_ft_r5.yaml`` at its widths (512 envs, 16
    updates of batch 1024 per step, history 8), warm-started from [16c]'s
    ``student.pt``, ``rollout_steps`` cut from 128 to 16, two iterations and
    the final eval. The actor equals the student before the first update."""
    cfg = load_config(default_config_path().parent / FT_YAML,
                      [f"training.rollout_steps={FT_ROLLOUT}", "logging.tensorboard=false",
                       f"training.warm_start_actor={student_path}", *FT_EXTRA])
    n = cfg.training.num_envs
    cfg.training.total_timesteps = 2 * n * FT_ROLLOUT
    tr = Trainer(cfg, output_dir=scratch / "student_ft", device=dev)
    assert diff_states(tr.carry.agent.actor, student) == []
    assert tr.carry.agent.ema_actor is not None and diff_states(tr.carry.agent.ema_actor,
                                                                 student) == []
    evals: list = []
    counting_evals(tr, evals)
    k1.step_kernel.launches = 0
    result = tr.train()
    launches = k1.step_kernel.launches
    iters = result["iterations"]
    assert iters == 2 and launches == iters * FT_ROLLOUT + sum(k for k, _, _ in evals)
    metrics = {k: v for k, v in result.items() if k.startswith("eval_")}
    assert all(math.isfinite(v) for v in metrics.values()), metrics
    train_s = result["stage_timing"]["train_iteration"]["total_sec"]
    log(f"[16e] {FT_YAML} ({n} envs, SAC batch {tr.sac_cfg.batch_size}, "
        f"{cfg.training.updates_per_step} updates per step, view {tr.loop_cfg.obs_dim} x history "
        f"{tr.loop_cfg.history_len}; rollout_steps cut from 128 to {FT_ROLLOUT}) warm-started "
        f"from [16c]'s student.pt (actor and EMA actor equal to the student bit for bit): "
        f"{result['stage_timing']['train_iteration']['mean_sec']:.4f} s per iteration, "
        f"{tr.carry.agent.step} updates in {train_s:.4f} s = {tr.carry.agent.step / train_s:.1f} "
        f"updates/s; K1 launches {launches}; final eval: "
        + ", ".join(f"{k} {v:.4g}" for k, v in sorted(metrics.items())
                    if k.endswith(("success_rate", "reward_mean"))))
    tr.logger.close()
    return launches


def pilot_card_vs_cpu(dev, sched: demos.LQRSchedule) -> int:
    """[16e]: the pilot card vs CPU, 8 episodes x 32 particles x 16 steps of
    act, env step and observe on the same draws: the filter's bodies at the
    contact bars every step, the resampled swarms' draws equal (an index
    that flips at a cumulative-weight boundary would move a particle's draw:
    counted, with its env left out of the holds after it)."""
    c = PILOT_CHECK
    params = _suite_env_params("robustness", obs_overrides={"drift_obs_enabled": True})
    pcfg = pilot.PilotConfig(particles=c["particles"])
    n, p = c["episodes"], c["particles"]
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(SEED + 67)
    reset_draws = rocket_env.draw_reset(params, n, cpu, gen)
    u_dr = torch.rand((n, p, 7), generator=gen) * 2.0 - 1.0
    n_dr = torch.randn((n, p, 3), generator=gen)
    steps = [(torch.randn((n, 7), generator=gen),
              pilot.ResampleDraws(u=torch.rand(n, generator=gen),
                                  n_jit=torch.randn((n, p, 8), generator=gen)))
             for _ in range(c["steps"])]
    runs = {}
    for where in (cpu, dev):
        states, obs = rocket_env.reset(params, n, where, draws=to_device(reset_draws, where))
        ps = pilot.init_pilot(obs, params, pcfg, u_dr.to(where), n_dr.to(where))
        sched_w = sched.to(where)
        k1.step_kernel.launches = 0
        trace = []
        for n_imu, rd in steps:
            ps, act = pilot.pilot_act(ps, sched_w, params, pcfg)
            states, out = rocket_env.batched_step(states, act, params, n_imu=n_imu.to(where))
            ps = pilot.pilot_observe(ps, out.obs, params, pcfg, to_device(rd, where))
            trace.append((ps.filt.bodies, ps.filt.dr.mass))
        runs[where.type] = (trace, k1.step_kernel.launches)
    flipped = torch.zeros(n, dtype=torch.bool)
    for (body_a, mass_a), (body_b, mass_b) in zip(runs[dev.type][0], runs["cpu"][0]):
        flipped |= ((mass_a.cpu() - mass_b).abs() > 1e-4).any(1)
        keep = ~flipped
        for f in ("pos", "quat", "vel", "omega"):
            torch.testing.assert_close(getattr(body_a, f).cpu()[keep], getattr(body_b, f)[keep],
                                       **CONTACT, msg=f)
    assert int(flipped.sum()) <= 1, flipped
    launches = runs[dev.type][1]
    assert launches == 2 * c["steps"], launches   # the env's step and the swarm's prediction
    log(f"[16e] pilot card vs CPU ({n} episodes x {p} particles x {c['steps']} steps): the "
        f"filter's bodies at the contact bars every step, resampled draws equal; envs with a "
        f"flipped resampling index {int(flipped.sum())} (bound 1); K1 launches {launches} "
        f"(env + prediction per step): ok")
    return launches


def run_pilot_eval(dev) -> int:
    """[16e]: ``python -m tvc_ai_torch.pilot_eval`` at its defaults' width
    (512 episodes x 192 particles = 98,304 particle rows a filter step) for
    64 steps, one library selection at step 25 over the port's copy of the
    19-controller library (512 x 8 samples x 19 = 77,824 rows x up to 500
    steps)."""
    argv = [*PILOT_CLI, "--library", str(LIBRARY)]
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    assert pilot_eval.main(argv) == 0
    launches = k1.step_kernel.launches
    log(f"[16e] python -m tvc_ai_torch.pilot_eval {' '.join(argv)}: exit 0 in "
        f"{time.perf_counter() - t0:.3f} s (the schedule's design and verification included; "
        f"the per-step and selection seconds are its [pilot: ...] line above); K1 launches "
        f"{launches} (600 verification + 64 env + 64 prediction + the selection's scoring steps)")
    return launches


# ---- [17] the single-env surface: the gym envs (or their gymnasium-free
# classes), the legacy mini training, the six research diagnostics
SINGLE_HORIZON = 1000          # [17a] the legacy env's steps in all; the enhanced env's
                               # episode's horizon (the envs' default)
SINGLE_AMP = 0.05              # [17a] the legacy episodes' seeded actions, uniform +-0.05
LEGACY_MINI = dict(episodes=3, steps=60, hidden=[32, 32])   # [17b] tests/test_integration.py's
# [17c] each CLI's arguments, its depth cut, and whether its --cpu run is compared
PROBE_CG, PROBE_STEPS = "0.01", "300"          # cut from the defaults' 4-5 offsets x 900 steps
DIAG_EPISODES, DIAG_HORIZON, DIAG_STEPS = 64, 128, 200
PROBE_BAR = 0.02   # [17c] a verbose line's number card vs --cpu: two units of its 0.01 print


def single_env_classes() -> tuple[type, type, str]:
    """``(RocketTVCEnv, EnhancedRocketTVCEnv, why)`` where gymnasium imports,
    else their gymnasium-free classes ``env.single.RocketTVC`` /
    ``EnhancedRocketTVC``, whose reset and step the gym classes inherit."""
    try:
        import gymnasium
        from tvc_ai_torch.env.wrappers import EnhancedRocketTVCEnv, RocketTVCEnv
    except ImportError as exc:
        from tvc_ai_torch.env.single import EnhancedRocketTVC, RocketTVC

        return RocketTVC, EnhancedRocketTVC, f"gymnasium does not import here ({exc})"
    return RocketTVCEnv, EnhancedRocketTVCEnv, f"gymnasium {gymnasium.__version__} imports"


def fly_single_env(env, resets: list, actions: np.ndarray, n_imu: torch.Tensor,
                   horizon: int, one_episode: bool) -> list:
    """Episodes of ``env`` from ``resets[k]`` (one env's ``ResetDraws``) with
    step t's action ``actions[t]`` and IMU draw ``n_imu[t]``, until
    ``horizon`` steps in all, or the first episode's end if ``one_episode``.
    Returns one row per reset or step: (obs, reward, terminated, truncated,
    info)."""
    at = iter(range(horizon))
    env.step_draws = lambda: (n_imu[next(at)], None)
    rows, t = [], 0
    for reset_draws in resets:
        obs, _ = env.reset(options={"reset_draws": reset_draws})
        rows.append((obs, 0.0, False, False, None))
        while t < horizon:
            rows.append(env.step(actions[t]))
            t += 1
            if rows[-1][2] or rows[-1][3]:
                break
        if one_episode or t == horizon:
            return rows
    raise AssertionError(f"{len(resets)} resets ran out at step {t}")


def single_env_card_vs_cpu(dev) -> dict:
    """[17a]: ``RocketTVCEnv`` (sensor noise on, seeded actions) flies
    consecutive episodes, each from its own reset draws, for 1,000 steps in
    all, and ``EnhancedRocketTVCEnv`` (curiosity on, sensor noise on, zero
    actions: it stands to a mission success) one episode of up to 1,000
    steps, on the card and on the CPU from the same reset and IMU draws.
    The legacy env flies with DR off: at its nominal mass it lifts off and
    climbs to the altitude ceiling in 150-200 steps, clear of the ground,
    where a crash through contact amplifies K1's rounding past the obs bar
    within 30 steps (seen at DR on); K1 with random DR rows at N = 1 is
    held in [9a]. Held: obs 5e-5 / 5e-4, reward 1e-3, the flags and every
    episode's length exact; K1 at N = 1 once per card step, one
    device-to-host read per reset and step. Returns the K1 launches by env."""
    legacy_cls, enhanced_cls, why = single_env_classes()
    log(f"[17a] single-env classes: {legacy_cls.__module__}.{legacy_cls.__name__} / "
        f"{enhanced_cls.__name__} ({why})")
    cpu = torch.device("cpu")
    launches = {}
    for name, cls, amp in (("RocketTVCEnv", legacy_cls, SINGLE_AMP),
                           ("EnhancedRocketTVCEnv", enhanced_cls, 0.0)):
        legacy = cls is legacy_cls
        gen = torch.Generator().manual_seed(SEED + 70)
        rng = np.random.default_rng(SEED + 70)
        actions = rng.uniform(-amp, amp, size=(SINGLE_HORIZON, 2)).astype(np.float32)
        n_imu = torch.randn((SINGLE_HORIZON, 7), generator=gen)
        host_env = cls(sensor_noise=True, seed=SEED, device=cpu)
        resets = [rocket_env.draw_reset(host_env.core.params, 1, cpu, gen)
                  for _ in range(SINGLE_HORIZON if legacy else 1)]
        runs = {}
        for side, where in (("cpu", cpu), ("card", dev)):
            env = host_env
            if side == "card":
                env = cls(sensor_noise=True, seed=SEED, device=dev)
                if not legacy:   # the CPU env's ICM carried across
                    env._icm.nets.load_state_dict(host_env._icm.nets.state_dict())
            k1.step_kernel.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows = fly_single_env(env, resets, actions, n_imu.to(where), SINGLE_HORIZON,
                                  one_episode=not legacy)
            runs[side] = dict(rows=rows, secs=time.perf_counter() - t0,
                              launches=k1.step_kernel.launches, reads=env.core.reads)
        a, b = runs["card"], runs["cpu"]
        episodes = sum(r[4] is None for r in b["rows"])
        steps = len(b["rows"]) - episodes
        assert len(a["rows"]) == len(b["rows"]), f"{name}: rows card {len(a['rows'])} " \
                                                 f"vs CPU {len(b['rows'])}"
        d_obs = d_rew = d_icm = top = of_bar = 0.0
        for t, (ra, rb) in enumerate(zip(a["rows"], b["rows"])):
            assert (ra[4] is None) == (rb[4] is None), f"{name} row {t}: the episodes part"
            torch.testing.assert_close(torch.from_numpy(ra[0]), torch.from_numpy(rb[0]),
                                       msg=f"{name} row {t} obs", **OBS)
            torch.testing.assert_close(torch.tensor(ra[1]), torch.tensor(rb[1]),
                                       msg=f"{name} row {t} reward", **REWARD)
            assert ra[2:4] == rb[2:4], f"{name} row {t} flags card {ra[2:4]} vs CPU {rb[2:4]}"
            d_obs = max(d_obs, float(np.abs(ra[0] - rb[0]).max()))
            of_bar = max(of_bar, float((np.abs(ra[0] - rb[0]) / (OBS["atol"] + OBS["rtol"]
                                                                 * np.abs(rb[0]))).max()))
            d_rew = max(d_rew, abs(ra[1] - rb[1]))
            if not legacy and rb[4] is not None:   # the curiosity bonus, held at 1e-5
                d_icm = max(d_icm, abs(ra[4]["intrinsic_reward"] - rb[4]["intrinsic_reward"]))
                top = max(top, abs(rb[4]["intrinsic_reward"]))
        assert d_icm <= 1e-5 + 1e-5 * top, (name, d_icm)
        bonus = "" if legacy else f", max |d intrinsic_reward| {d_icm:.3e} (its ICM carried across)"
        assert a["launches"] == steps, (name, a["launches"], steps)
        assert a["reads"] == steps + episodes, (name, a["reads"], steps, episodes)
        launches[name] = a["launches"]
        lengths, ends = [], []
        for r in b["rows"]:
            if r[4] is None:
                lengths.append(0)
                ends.append("horizon")
            else:
                lengths[-1] += 1
                ends[-1] = ("success" if r[4]["mission_successful"] else "crash"
                            if r[4]["crashed"] else "truncated" if r[3] else "terminated"
                            if r[2] else "horizon")
        log(f"[17a] {name} (sensor noise, "
            f"{'seeded actions +-' + str(amp) if amp else 'zero actions'}): {episodes} "
            f"episode(s), {steps} steps (lengths {min(lengths)}-{max(lengths)}, ends "
            f"{ {e: ends.count(e) for e in sorted(set(ends))} }), card (K1 at N = 1) vs CPU: "
            f"max |d obs| {d_obs:.3e} ({of_bar:.3f} of its bar at worst), max |d reward| "
            f"{d_rew:.3e}{bonus}, flags and lengths "
            f"equal: ok; card {a['secs'] / (steps + episodes) * 1e3:.3f} ms per reset or step "
            f"on the host clock, {a['reads'] / (steps + episodes):.2f} device-to-host reads per "
            f"reset or step, K1 launches {a['launches']} == steps taken; CPU "
            f"{b['secs'] / (steps + episodes) * 1e3:.3f} ms")
    return launches


def legacy_mini_training(dev) -> int:
    """[17b]: ``tests/test_integration.py``'s mini training on the card:
    ``RocketTVCEnv`` + ``agents.legacy.SACAgent`` (32x32), 3 episodes x 60
    steps, one update per step once 32 transitions are stored. Returns its
    K1 launches."""
    from tvc_ai_torch.agents.legacy import SACAgent, SACConfig

    legacy_cls, _, _ = single_env_classes()
    c = LEGACY_MINI
    env = legacy_cls(max_episode_steps=c["steps"], seed=SEED, device=dev)
    agent = SACAgent(8, 2, SACConfig(hidden_dims=c["hidden"], batch_size=16, buffer_size=4096,
                                     learning_starts=32), seed=SEED, device=dev)
    k1.step_kernel.launches = 0
    rewards, steps = [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(c["episodes"]):
        obs, _ = env.reset()
        total = 0.0
        for _ in range(c["steps"]):
            action = agent.select_action(obs)
            next_obs, reward, terminated, truncated, _ = env.step(action)
            agent.store_transition(obs, action, reward, next_obs, terminated or truncated)
            agent.train()
            total += reward
            obs = next_obs
            steps += 1
            if terminated or truncated:
                break
        rewards.append(total)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    assert all(math.isfinite(r) for r in rewards) and agent.total_steps > 0, rewards
    assert k1.step_kernel.launches == steps, (k1.step_kernel.launches, steps)
    log(f"[17b] legacy mini training on the card ({legacy_cls.__name__} + SACAgent "
        f"{c['hidden']}, {c['episodes']} episodes x up to {c['steps']} steps): {steps} env "
        f"steps, {agent.total_steps} agent steps, rewards "
        f"{', '.join(f'{r:.1f}' for r in rewards)} (finite) in {secs:.3f} s = "
        f"{secs / steps * 1e3:.3f} ms per env step + update; K1 launches "
        f"{k1.step_kernel.launches} == env steps")
    return steps


def captured_main(main, argv) -> tuple[int, str, float]:
    """A CLI's exit code, standard output and seconds."""
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    torch.cuda.synchronize()
    return rc, out.getvalue(), time.perf_counter() - t0


def compare_probe_runs(name: str, card: str, cpu: str) -> str:
    """[17c]: a probe's card output against its ``--cpu`` output. The result
    lines (``cg=...``) must be equal; each verbose line's numbers agree
    within ``PROBE_BAR``. Returns what differs as text: the count of lines
    that differ as printed and the ``t=`` at which the runs part."""
    card_lines, cpu_lines = card.rstrip().splitlines(), cpu.rstrip().splitlines()
    assert len(card_lines) == len(cpu_lines), (name, card_lines, cpu_lines)
    results = [(x, y) for x, y in zip(card_lines, cpu_lines) if y.startswith("cg=")]
    assert results and all(x == y for x, y in results), (name, results)
    number = r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?"
    differ = []
    for x, y in zip(card_lines, cpu_lines):
        if x == y:
            continue
        nx, ny = re.findall(number, x), re.findall(number, y)
        assert re.sub(number, "#", x) == re.sub(number, "#", y), (name, x, y)
        worst = max(abs(float(u) - float(v)) for u, v in zip(nx, ny))
        assert worst <= PROBE_BAR, f"{name}: card {x!r} vs CPU {y!r} part by {worst}"
        differ.append(re.search(r"t=\s*(\d+)", y))
    if not differ:
        return f"all {len(cpu_lines)} lines equal"
    at = differ[0].group(1) if differ[0] else "?"
    return (f"{len(differ)} of {len(cpu_lines)} lines differ as printed, every number within "
            f"{PROBE_BAR}; the runs part at t={at}")


def run_single_env_clis(scratch: Path, student_path: Path) -> dict:
    """[17c]: the six research diagnostics through ``main([...])`` on the
    card at a cut depth: ``lqr_balance`` and ``scripted_controller`` at one
    CG offset and 300 steps (their own ``--steps``), each against the same
    call with ``--cpu`` (the result lines and exit codes equal, the verbose
    lines within ``PROBE_BAR``); ``inspect_policy`` and ``diagnose_cg`` on
    [9]'s trained actor at 200 steps; ``policy_breakdown`` on [16c]'s
    ``student.pt`` and ``ablate_dr`` on [9]'s checkpoint at 64 episodes and
    a 128-step horizon. Where a CLI has no flag for the horizon, the cut
    patches the env parameters it builds, as the CPU tests do. Returns each
    CLI's K1 launches."""
    from unittest import mock

    from tvc_ai_torch import (ablate_dr, diagnose_cg, inspect_policy, lqr_balance,
                              policy_breakdown, scripted_controller)

    def horizon_cut(fn, steps: int, at: int = 1):
        """``fn`` with its ``at``-th argument's ``max_episode_steps`` cut."""
        def cut(*args, **kwargs):
            args = list(args)
            args[at] = dataclasses.replace(args[at], max_episode_steps=steps)
            return fn(*args, **kwargs)
        return cut

    def suite_cut(*args, **kwargs):
        params = suite_params(*args, **kwargs)
        return dataclasses.replace(params, max_episode_steps=DIAG_HORIZON)

    suite_params, axes = policy_breakdown.suite_params, ablate_dr.axes
    ckpt = str(scratch / "run1" / "checkpoints")
    probe = ["--cg", PROBE_CG, "--steps", PROBE_STEPS, "--verbose"]
    none = contextlib.nullcontext()
    runs = {
        "lqr_balance": (lqr_balance.main, probe, none,
                        f"--cg {PROBE_CG} (from 5 offsets), --steps {PROBE_STEPS} (from 900)"),
        "scripted_controller": (scripted_controller.main, probe, none,
                                f"--cg {PROBE_CG} (from 4 offsets), --steps {PROBE_STEPS} "
                                "(from 900)"),
        "inspect_policy": (inspect_policy.main, ["--model_path", ckpt, "--episodes", "1"],
                           mock.patch.object(inspect_policy, "inspect", horizon_cut(
                               inspect_policy.inspect, DIAG_STEPS)),
                           f"--episodes 1 (from 3), the horizon {DIAG_STEPS} steps (from 1000)"),
        "diagnose_cg": (diagnose_cg.main, ["--model_path", ckpt, "--cg", "0.02", "--steps",
                                           str(DIAG_STEPS)], none,
                        f"--cg 0.02 (from 4 offsets), --steps {DIAG_STEPS} (from 1000)"),
        "policy_breakdown": (policy_breakdown.main,
                             ["--model", str(student_path), "--episodes", str(DIAG_EPISODES)],
                             mock.patch.object(policy_breakdown, "suite_params", suite_cut),
                             f"--episodes {DIAG_EPISODES} (from 1024), the horizon "
                             f"{DIAG_HORIZON} steps (from the suite's 2000)"),
        "ablate_dr": (ablate_dr.main, ["--model_path", ckpt, "--episodes", str(DIAG_EPISODES)],
                      mock.patch.object(ablate_dr, "axes",
                                        lambda horizon=1000: axes(DIAG_HORIZON)),
                      f"--episodes {DIAG_EPISODES} (64, its default), the horizon "
                      f"{DIAG_HORIZON} steps (from 1000)"),
    }
    launches = {}
    for name, (main, argv, cut_ctx, cut) in runs.items():
        k1.step_kernel.launches = 0
        with cut_ctx:
            rc, out, secs = captured_main(main, argv)
        launches[name] = k1.step_kernel.launches
        for line in out.rstrip().splitlines():
            if line.strip():
                log(f"[17c] {name}| {line}")
        assert rc in ((0, 1) if name in ("lqr_balance", "scripted_controller") else (0,)), \
            (name, rc)
        assert launches[name] > 0, f"{name} ran no K1 launch"
        log(f"[17c] python -m tvc_ai_torch.{name}: exit {rc} in {secs:.3f} s, K1 launches "
            f"{launches[name]}; cut: {cut}")
        if name in ("lqr_balance", "scripted_controller"):
            cpu_rc, cpu_out, cpu_secs = captured_main(main, [*argv, "--cpu"])
            assert rc == cpu_rc, (name, rc, cpu_rc)
            log(f"[17c] {name} card vs --cpu: exit {rc} == {cpu_rc}, result line equal, "
                f"{compare_probe_runs(name, out, cpu_out)}; CPU {cpu_secs:.3f} s")
    return launches


HPO_TRIALS = 3                 # [18b] --n_trials, cut from 20 (256 envs, 50,000 steps a trial)
QUAT_ROWS = 4096               # [18c] quaternions card vs CPU
QUAT_BAR = dict(atol=1e-6, rtol=0.0)
PPO_ACT_BAR = dict(atol=1e-5, rtol=0.0)
ACT_FN_ENVS, ACT_FN_STEPS = 256, 8   # [18c] the constant-act_fn iteration, updates from step 4
ACT_FN_ACTION = (0.3, -0.1)    # [18c] the reference's det_act (tests/test_loop.py)


def parity_card_vs_cpu(scratch: Path, dev) -> dict:
    """[18a]: the five PyBullet-parity scenarios through ``torch_trajectory``,
    K1 at N = 1 on the card (one launch per step, 210 in all) against its
    plain version on the CPU, held at the env observation bar; then
    ``python -m tvc_ai_torch.pybullet_goldens check`` (through ``main``) on a
    fixture written from the CPU trajectories exits 0 with ``PARITY PASS``.
    Returns the K1 launches of the trajectories and of the check."""
    pp = pybullet_parity
    cpu_traj, launches, total_steps = {}, {}, 0
    for sc in pp.SCENARIOS:
        actions = sc.actions()
        t0 = time.perf_counter()
        cpu_traj[sc.name] = pp.torch_trajectory(actions, device="cpu")
        cpu_s = time.perf_counter() - t0
        k1.step_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = pp.torch_trajectory(actions, device=dev)
        card_s = time.perf_counter() - t0
        launches[sc.name] = k1.step_kernel.launches
        assert launches[sc.name] == sc.steps, (sc.name, launches[sc.name])
        total_steps += sc.steps
        want = cpu_traj[sc.name]
        torch.testing.assert_close(torch.from_numpy(card), torch.from_numpy(want),
                                   msg=f"[18a] {sc.name}", **OBS)
        d = np.abs(card - want)
        of_bar = float((d / (OBS["atol"] + OBS["rtol"] * np.abs(want))).max())
        log(f"[18a] {sc.name} ({sc.steps} steps, lowest z {want[:, 2].min():.3f} m): card (K1 "
            f"at N = 1) vs CPU max |d| {d.max():.3e} ({of_bar:.3f} of the bar "
            f"{OBS['atol']} + {OBS['rtol']}|ref|), max |d pos| {d[:, :3].max():.3e}, max |d "
            f"quat| {d[:, 3:7].max():.3e}; K1 launches {launches[sc.name]}; card "
            f"{card_s / sc.steps * 1e3:.3f} ms per step on the host clock (one device-to-host "
            f"copy per scenario), CPU {cpu_s / sc.steps * 1e3:.3f} ms")
    fixture = pp.write_goldens(scratch / "pybullet_goldens_cpu.npz", cpu_traj)
    k1.step_kernel.launches = 0
    rc, out, secs = captured_main(pybullet_goldens.main, ["check", "--fixture", str(fixture)])
    check_launches = k1.step_kernel.launches
    assert rc == 0 and out.rstrip().endswith("PARITY PASS"), (rc, out[-500:])
    report = json.loads(out[:out.rindex("PARITY PASS")])
    worst_pos = max(r["max_pos_err_m"] for r in report["scenarios"].values())
    worst_dot = min(r["min_quat_dot"] for r in report["scenarios"].values())
    assert check_launches == total_steps, (check_launches, total_steps)
    log(f"[18a] python -m tvc_ai_torch.pybullet_goldens check --fixture <CPU trajectories>: "
        f"exit {rc}, PARITY PASS over {len(report['scenarios'])} scenarios (max pos err "
        f"{worst_pos:.3e} m, min quat dot {worst_dot:.9f}) in {secs:.3f} s; K1 launches "
        f"{check_launches} == {total_steps} steps")
    return {"parity_card_vs_cpu": sum(launches.values()), "parity_check_cli": check_launches}


def run_hpo(scratch: Path) -> int:
    """[18b]: ``python -m tvc_ai_torch.tune_hyperparameters`` (through
    ``main``) at its defaults' width, 256 envs and 50,000 env steps a trial
    (3 iterations of 64 steps, an 8-episode eval after each), trials cut to
    ``HPO_TRIALS``. Its trials' parameters must equal the draws of the same
    seed on the CPU; every score finite. Returns its K1 launches."""
    out_dir = scratch / "hpo"
    k1.step_kernel.launches = 0
    rc, out, secs = captured_main(tune_hyperparameters.main,
                                  ["--n_trials", str(HPO_TRIALS), "--output_dir", str(out_dir)])
    launches = k1.step_kernel.launches
    for line in out.rstrip().splitlines():
        log(f"[18b] tune_hyperparameters| {line}")
    assert rc == 0, rc
    trials = json.loads((out_dir / "trials.json").read_text())

    def draw_only(trial):
        hpo.default_search_space(trial)
        return 0.0

    _, drawn = hpo.run_study(draw_only, HPO_TRIALS, 0)
    assert [t["params"] for t in trials] == [r.params for r in drawn], (trials, drawn)
    assert all(math.isfinite(v) for t in trials for v in [t["value"], *t["intermediate"]]), trials
    iters, steps = 50_000 // (256 * hpo.ROLLOUT_STEPS), 256 * hpo.ROLLOUT_STEPS
    scores = ", ".join(f"{t['value']:.2f}" for t in trials)
    assert launches > HPO_TRIALS * iters * hpo.ROLLOUT_STEPS, launches
    log(f"[18b] {HPO_TRIALS} trials (cut from 20) of {iters} iterations x {steps} env steps at "
        f"256 envs in {secs:.3f} s = {secs / HPO_TRIALS:.3f} s per trial; trial parameters "
        f"equal the CPU's draws of seed 0; scores {scores}; hidden "
        f"{[t['params']['hidden_dim'] for t in trials]}, batch "
        f"{[t['params']['batch_size'] for t in trials]}; K1 launches {launches} (of which "
        f"{HPO_TRIALS * iters * hpo.ROLLOUT_STEPS} training steps, the rest eval steps)")
    return launches


def remnants_card_vs_cpu(dev, short: EnvParams) -> int:
    """[18c]: the reference's remaining names card vs CPU: ``to_matrix``,
    ``tilt_from_up`` (tilts of 0.3 rad and more: arccos near 1 amplifies one
    rounding step) and ``random_tilt_quaternion`` at 1e-6 on 4096 rows;
    ``ppo.select_action`` deterministic and stochastic (same normals) at 1e-5;
    one 8-step iteration of 256 envs with the constant ``act_fn`` at [7]'s
    bars (the safety layer off, so that the replay holds the hook's actions),
    its stored actions exactly the constant; ``DeviceManager("cuda")``'s
    memory info. Returns the iteration's K1 launches."""
    cpu = torch.device("cpu")
    rng = np.random.default_rng(SEED + 80)
    q = rng.normal(size=(QUAT_ROWS, 4)).astype(np.float32)
    q = torch.from_numpy(q / np.linalg.norm(q, axis=-1, keepdims=True))
    tilt = torch.from_numpy(rng.uniform(0.3, 3.0, QUAT_ROWS).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(QUAT_ROWS, 2)).astype(np.float32))
    az = torch.from_numpy(rng.uniform(0.0, 2 * np.pi, QUAT_ROWS).astype(np.float32))
    tilted = quaternion.from_axis_angle(
        torch.stack([torch.cos(az), torch.sin(az), torch.zeros_like(az)], -1), tilt)
    errs = {}
    for name, fn, x in (("to_matrix", quaternion.to_matrix, q),
                        ("tilt_from_up", quaternion.tilt_from_up, tilted),
                        ("random_tilt_quaternion",
                         lambda v: quaternion.random_tilt_quaternion(0.3, u=v), u)):
        want, got = fn(x), fn(x.to(dev)).cpu()
        torch.testing.assert_close(got, want, msg=f"[18c] {name}", **QUAT_BAR)
        errs[name] = float((got - want).abs().max())
    torch.testing.assert_close(quaternion.tilt_from_up(tilted), tilt, atol=1e-5, rtol=0.0)

    ppo_cfg = ppo.PPOConfig()
    obs = torch.randn((N_ENVS, 10), generator=torch.Generator().manual_seed(SEED + 81))
    noise = torch.randn((N_ENVS, 2), generator=torch.Generator().manual_seed(SEED + 82))
    states = {where: ppo.init(10, 2, ppo_cfg, where, seed=SEED) for where in (cpu, dev)}
    for deterministic in (True, False):
        want = ppo.select_action(states[cpu], obs, deterministic, noise)
        got = ppo.select_action(states[dev], obs.to(dev), deterministic, noise.to(dev)).cpu()
        torch.testing.assert_close(got, want, **PPO_ACT_BAR)
        errs[f"ppo.select_action {'deterministic' if deterministic else 'stochastic'}"] = float(
            (got - want).abs().max())

    n, steps = ACT_FN_ENVS, ACT_FN_STEPS
    sac_cfg = sac.SACConfig(**dict(DEFAULT_SAC, buffer_size=32 * n, learning_starts=4 * n))
    loop_cfg = loop.TrainLoopConfig(**dict(DEFAULT_LOOP, num_envs=n, rollout_steps=steps,
                                           use_safety_layer=False), obs_dim=obs_dim(short))
    reset_draws, iter_draws = learner_draws(short, n, steps, sac_cfg,
                                            torch.Generator().manual_seed(SEED + 83))

    def det_act(agent, policy_input, n_act, generator):
        return torch.tensor([ACT_FN_ACTION], device=policy_input.device).expand(
            policy_input.shape[0], 2)

    runs = {}
    for side, where in (("cpu", cpu), ("card", dev)):
        carry = loop.init_carry(short, sac_cfg, loop_cfg, device=where, seed=SEED,
                                reset_draws=to_device(reset_draws, where))
        k1.step_kernel.launches = 0
        runs[side] = loop.make_train_iteration(sac_cfg, loop_cfg, act_fn=det_act)(
            carry, short, to_device(iter_draws, where))
    launches = k1.step_kernel.launches
    torch.cuda.synchronize()
    (a, am), (b, bm) = runs["card"], runs["cpu"]
    assert launches == steps, launches
    stored = a.buffer.data["action"][:a.buffer.size].cpu()
    assert torch.equal(stored, torch.tensor([ACT_FN_ACTION]).expand(steps * n, 2)), "actions"
    assert a.agent.step == b.agent.step == steps - 3, (a.agent.step, b.agent.step)
    for k in ("obs", "next_obs"):
        torch.testing.assert_close(a.buffer.data[k].cpu(), b.buffer.data[k], **OBS, msg=k)
    torch.testing.assert_close(a.buffer.data["reward"].cpu(), b.buffer.data["reward"], **REWARD)
    assert torch.equal(a.buffer.data["done"].cpu(), b.buffer.data["done"]), "terminated differs"
    for k in bm:
        torch.testing.assert_close(am[k].cpu(), bm[k], **METRICS, msg=k)
    param_err = max(net_param_err(getattr(a.agent, net), getattr(b.agent, net), net)
                    for net in ("actor", "critic", "target_critic"))

    dm = DeviceManager("cuda")
    info = dm.get_memory_info()
    assert dm.platform == "cuda" and not dm.is_tpu and info["bytes_limit"] > 0, info
    assert dm.device_count() == torch.cuda.device_count()
    dm.synchronize()
    log("[18c] card vs CPU: " + ", ".join(f"{k} max |d| {v:.3e}" for k, v in errs.items())
        + f" (quaternions at {QUAT_BAR['atol']}, actions at {PPO_ACT_BAR['atol']}): ok")
    log(f"[18c] train iteration with act_fn = the constant {ACT_FN_ACTION} ({n} envs x {steps} "
        f"steps, {a.agent.step} updates), card (K1) vs CPU: every stored action the constant, "
        f"max |d param| {param_err:.3e} (atol {PARAMS['atol']}), metrics at [7]'s bars; K1 "
        f"launches {launches}")
    log(f"[18c] DeviceManager('cuda'): {dm.device}, bytes_in_use {info['bytes_in_use']:.0f}, "
        f"bytes_limit {info['bytes_limit']:.0f}, peak_bytes_in_use "
        f"{info['peak_bytes_in_use']:.0f}"
        + (f", host_ram_used_frac {info['host_ram_used_frac']:.3f}"
           if "host_ram_used_frac" in info else ", psutil does not import here"))
    return launches


def plots_of_trainer_run(scratch: Path) -> None:
    """[18d]: ``load_csv_metrics`` over [9]'s ``metrics.csv``; the plots where
    matplotlib imports, else one line that says so."""
    run = scratch / "run1"
    series = viz.load_csv_metrics(run / "metrics.csv")
    assert series, "no key metric in [9]'s metrics.csv"
    log("[18d] load_csv_metrics(run1/metrics.csv): " + ", ".join(
        f"{tag} {len(steps)} points" for tag, (steps, _) in series.items()))
    if importlib.util.find_spec("matplotlib") is None:
        log("[18d] matplotlib does not import here: no plots rendered")
        return
    artifacts = viz.create_plots(run, scratch / "plots")
    log(f"[18d] plots: {', '.join(f'{a.name} ({a.stat().st_size} B)' for a in artifacts)}")


BF16_WIDTH = (32, 32)            # [19a] card vs CPU at width 32
BF16_ROWS = 256                  # [19a] the forward passes' rows and the update's batch
BF16_FWD = dict(atol=1e-4, rtol=1e-3)   # bf16 forward bar (tests/test_torch_bf16.py)
BF16_DELTA = 1e-5                # an update's parameter delta card vs CPU, but for
BF16_DELTA_SHARE = 0.01          # this share of elements whose tiny gradient rounds the other way
BF16_OBS = dict(atol=1e-3, rtol=1e-2)      # [19a] the bf16 iteration's obs, replay rows, reward
BF16_METRICS = dict(atol=1e-4, rtol=1e-2)  # [19a] the bf16 iteration's mean metrics
BF16_N, BF16_STEPS = 256, 16     # [19a] the bf16 iteration card vs CPU
BF16_PARTED = 8                  # [19a] at most 1 env in 8 parted by a rounding flip (as [16b])
WARM_UP_STEPS = 4                # [19a], [19b] a warm-up iteration's steps before the timed ones
BF16_ROBUST_STEPS = 4            # [19a] timed robust_full_r4d.yaml steps a dtype and turn
DTYPES = ("float32", "bfloat16")


def held_update_deltas(card, host, before: dict, lrs: dict) -> tuple[float, int]:
    """One update's parameter deltas card vs CPU per network: all but
    BF16_DELTA_SHARE of the elements within BF16_DELTA, every element within
    2 × lr + BF16_DELTA (Adam's first step is ±lr: a gradient near zero that
    rounds to the other sign moves 2 × lr). Returns (largest difference,
    elements beyond BF16_DELTA)."""
    worst, over = 0.0, 0
    for net, lr in lrs.items():
        got = torch.cat([(p.detach().cpu() - b).flatten()
                         for p, b in zip(getattr(card, net).parameters(), before[net])])
        want = torch.cat([(q.detach() - b).flatten()
                          for q, b in zip(getattr(host, net).parameters(), before[net])])
        err = (got - want).abs()
        n_over = int((err > BF16_DELTA).sum())
        assert n_over <= BF16_DELTA_SHARE * err.numel(), (net, n_over, err.numel())
        assert float(err.max()) <= 2 * lr + BF16_DELTA, (net, float(err.max()), lr)
        worst, over = max(worst, float(err.max())), over + n_over
    return worst, over


def held_bf16_params(a, b, cfg: sac.SACConfig, updates: int) -> tuple[float, int]:
    """A bf16 learner card vs CPU after ``updates`` updates: all but
    BF16_DELTA_SHARE of each tensor's elements within PARAMS, every element
    within PARAMS plus the most Adam could move it (MAX_ADAM_STEP × the
    network's learning rate × ``updates``). Returns (largest difference,
    elements beyond PARAMS)."""
    worst, over = 0.0, 0
    for net, lr in (("actor", cfg.lr_actor), ("critic", cfg.lr_critic),
                    ("target_critic", cfg.lr_critic)):
        for (name, p), q in zip(getattr(a, net).named_parameters(), getattr(b, net).parameters()):
            d = (p.detach().cpu() - q.detach()).abs()
            n_over = int((d > PARAMS["atol"]).sum())
            assert n_over <= max(1, int(BF16_DELTA_SHARE * d.numel())), (net, name, n_over)
            assert float(d.max()) <= PARAMS["atol"] + MAX_ADAM_STEP * lr * updates, (net, name)
            worst, over = max(worst, float(d.max())), over + n_over
    return worst, over


def bf16_card_vs_cpu(dev, short: EnvParams) -> int:
    """[19a]: ``compute_dtype="bfloat16"`` at width 32, card against CPU: the
    actor's and the critic's forward passes at BF16_FWD, one ``sac.update``
    by its parameter deltas (``held_update_deltas``) and its losses at 1e-3
    relative, then a 16-step train iteration of 256 envs (learning from the
    fourth step): its metrics at BF16_METRICS, its learner by
    ``held_bf16_params``; every env but those parted by a rounding flip with
    its stored and final obs, actions and rewards at BF16_OBS, its
    terminations and episode counts equal. Once the learned actors differ
    by float32 rounding (~1e-7), a weight or activation that rounds to the
    other bfloat16 neighbour moves an action by ~3e-3, and the env's state
    parts from there on (the CPU alone parts so under a 1e-7 perturbation of
    its actor); an env is parted from the first step where its action
    differs by more than BF16_FWD, and at most 1 env in BF16_PARTED may
    part. Returns the iteration's K1 launches."""
    n_obs = obs_dim(short)
    gen = torch.Generator().manual_seed(SEED + 90)
    cfg = sac.SACConfig(**dict(DEFAULT_SAC, hidden_dims=BF16_WIDTH, batch_size=BF16_ROWS,
                               compute_dtype="bfloat16"))
    sides = {"cpu": torch.device("cpu"), "card": dev}
    agents = {k: sac.init(n_obs, 2, cfg, device=w, seed=SEED) for k, w in sides.items()}
    assert agents["card"].actor.dtype == agents["card"].critic.q1.dtype == torch.bfloat16
    batch = {"obs": torch.randn(BF16_ROWS, n_obs, generator=gen),
             "action": torch.rand(BF16_ROWS, 2, generator=gen) * 2.0 - 1.0,
             "reward": torch.randn(BF16_ROWS, generator=gen) * 30.0,
             "next_obs": torch.randn(BF16_ROWS, n_obs, generator=gen),
             "done": (torch.rand(BF16_ROWS, generator=gen) < 0.2).to(torch.float32)}
    with torch.no_grad():
        fwd = {k: (*s.actor(batch["obs"].to(sides[k])),
                   *s.critic(batch["obs"].to(sides[k]), batch["action"].to(sides[k])))
               for k, s in agents.items()}
    fwd_err = 0.0
    for name, x, y in zip(("mean", "log_std", "q1", "q2"), fwd["card"], fwd["cpu"]):
        assert x.dtype == torch.float32, name
        torch.testing.assert_close(x.cpu(), y, **BF16_FWD, msg=name)
        fwd_err = max(fwd_err, float((x.cpu() - y).abs().max()))
    draws = sac.UpdateDraws(n_next=torch.randn(BF16_ROWS, 2, generator=gen),
                            n_pi=torch.randn(BF16_ROWS, 2, generator=gen))
    before = {net: [p.detach().clone() for p in getattr(agents["cpu"], net).parameters()]
              for net in ("actor", "critic")}
    upd = {k: sac.update(s, {n: v.to(sides[k]) for n, v in batch.items()}, cfg,
                         to_device(draws, sides[k]))[1]
           for k, s in agents.items()}
    torch.cuda.synchronize()
    delta_err, delta_over = held_update_deltas(agents["card"], agents["cpu"], before,
                                               {"actor": cfg.lr_actor, "critic": cfg.lr_critic})
    for k in upd["cpu"]:
        torch.testing.assert_close(upd["card"][k].cpu(), upd["cpu"][k], rtol=1e-3, atol=1e-6,
                                   msg=k)
    log(f"[19a] bf16 at width {BF16_WIDTH}, card vs CPU: forward ({BF16_ROWS} rows) max |d| "
        f"{fwd_err:.3e} (atol {BF16_FWD['atol']}, rtol {BF16_FWD['rtol']}); one sac.update's "
        f"parameter deltas max |d| {delta_err:.3e}, {delta_over} elements beyond "
        f"{BF16_DELTA}; critic_loss {float(upd['card']['critic_loss']):.6g} vs "
        f"{float(upd['cpu']['critic_loss']):.6g}: ok")

    it_sac = dataclasses.replace(cfg, batch_size=DEFAULT_SAC["batch_size"],
                                 buffer_size=32 * BF16_N, learning_starts=4 * BF16_N)
    it_loop = loop.TrainLoopConfig(**dict(DEFAULT_LOOP, num_envs=BF16_N, rollout_steps=BF16_STEPS),
                                   obs_dim=n_obs)
    reset_draws, iter_draws = learner_draws(short, BF16_N, BF16_STEPS, it_sac,
                                            torch.Generator().manual_seed(SEED + 91))
    runs = {}
    for k, where in sides.items():
        carry = loop.init_carry(short, it_sac, it_loop, device=where, seed=SEED,
                                reset_draws=to_device(reset_draws, where))
        it = loop.make_train_iteration(it_sac, it_loop)
        k1.step_kernel.launches = 0
        runs[k] = it(carry, short, to_device(iter_draws, where))
        launches = k1.step_kernel.launches
    torch.cuda.synchronize()
    (a, am), (b, bm) = runs["card"], runs["cpu"]
    updates = sum(1 for d in iter_draws if d.samples)
    assert a.agent.step == b.agent.step == updates > 0 and launches == BF16_STEPS, launches
    rows = BF16_STEPS * BF16_N
    card = {k: v[:rows].cpu().reshape(BF16_STEPS, BF16_N, -1) for k, v in a.buffer.data.items()}
    host = {k: v[:rows].reshape(BF16_STEPS, BF16_N, -1) for k, v in b.buffer.data.items()}
    act_off = ((card["action"] - host["action"]).abs()
               > BF16_FWD["atol"] + BF16_FWD["rtol"] * host["action"].abs()).any(-1)
    parted = torch.cumsum(act_off.to(torch.int32), 0) > 0     # (steps, envs): parted at or before
    n_parted = int(parted[-1].sum())
    assert n_parted <= BF16_N // BF16_PARTED, (n_parted, BF16_N // BF16_PARTED)
    before = ~torch.cat([torch.zeros_like(parted[:1]), parted[:-1]])   # not parted before step t
    for k, keep in (("obs", before), ("action", ~parted), ("reward", ~parted),
                    ("next_obs", ~parted)):
        torch.testing.assert_close(card[k][keep], host[k][keep], **BF16_OBS,
                                   msg=lambda m, k=k: f"{k}: {m}")
    assert torch.equal(card["done"][~parted], host["done"][~parted]), "terminated differs"
    whole = ~parted[-1]
    torch.testing.assert_close(a.obs.cpu()[whole], b.obs[whole], **BF16_OBS)
    for name in ("episodes", "ep_length"):
        assert torch.equal(getattr(a, name).cpu()[whole], getattr(b, name)[whole]), name
    for k in bm:
        torch.testing.assert_close(am[k].cpu(), bm[k], **BF16_METRICS, msg=k)
    param_err, param_over = held_bf16_params(a.agent, b.agent, it_sac, updates)
    log(f"[19a] bf16 train iteration {BF16_N} envs x {BF16_STEPS} steps at width {BF16_WIDTH}, "
        f"{updates} updates, card (K1) vs CPU: max |d obs| "
        f"{float((a.obs.cpu() - b.obs).abs().max()):.3e} (atol {BF16_OBS['atol']}, rtol "
        f"{BF16_OBS['rtol']}) but for {n_parted} of {BF16_N} envs parted by a rounding flip, "
        f"max |d action| {float((card['action'] - host['action']).abs().max()):.3e}, "
        f"the others' terminations and episode ends equal ({int(b.episodes.sum())} in all), "
        f"max |d param| {param_err:.3e} ({param_over} elements beyond {PARAMS['atol']}), "
        f"critic_loss {float(am['critic_loss']):.6g} vs {float(bm['critic_loss']):.6g}; "
        f"K1 launches {launches}: ok")
    return launches


def update_launches(agent, batch: dict, cfg: sac.SACConfig, gen: torch.Generator) -> int:
    """The device operations one ``sac.update`` launches, from a profiled call."""
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sac.update(agent, batch, cfg, generator=gen)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def timed_in_turns(runs: dict, order, env_params, steps: int) -> tuple[dict, int]:
    """One synchronised iteration of each ``runs[name] = [carry, iteration]``
    in ``order``, carrying on; returns (seconds by name, K1 launches)."""
    k1.step_kernel.launches = 0
    seconds = {name: [] for name in runs}
    for name in order:
        carry, it = runs[name]
        t0 = time.perf_counter()
        carry, metrics = it(carry, env_params)
        torch.cuda.synchronize()
        seconds[name].append(time.perf_counter() - t0)
        assert all(math.isfinite(float(v)) for v in metrics.values()), (name, metrics)
        runs[name][0] = carry
    launches = k1.step_kernel.launches
    assert launches == len(order) * steps, (launches, len(order) * steps)
    return seconds, launches


def bf16_full_width(dev, env_params: EnvParams) -> dict:
    """[19a]: the default configuration in float32 and in bfloat16, in turns
    (A B B A): one synchronised iteration of 4096 envs x 128 steps ([8]'s
    measure), one ``sac.update`` at batch 256 (device and host ms, [8b]'s
    measures, and its device operations), and ``robust_full_r4d.yaml``'s
    learning step (512 envs, 16 updates of batch 1024) over 4 steps. Returns
    the K1 launches of the timed runs."""
    n_obs = obs_dim(env_params)
    lp = loop.TrainLoopConfig(**DEFAULT_LOOP, obs_dim=n_obs)
    cfgs = {d: sac.SACConfig(**DEFAULT_SAC, compute_dtype=d) for d in DTYPES}
    runs = {}
    for d, cfg in cfgs.items():
        carry = loop.init_carry(env_params, cfg, lp, device=dev, seed=SEED + 6)
        carry, _ = loop.make_train_iteration(cfg, dataclasses.replace(
            lp, rollout_steps=WARM_UP_STEPS))(carry, env_params)
        runs[d] = [carry, loop.make_train_iteration(cfg, lp)]
    torch.cuda.synchronize()
    order = DTYPES + DTYPES[::-1]
    seconds, launches = timed_in_turns(runs, order, env_params, lp.rollout_steps)
    gen = torch.Generator(device=dev).manual_seed(SEED + 92)
    upd = {}
    for d in order:
        carry, cfg = runs[d][0], cfgs[d]
        batch = replay.sample(carry.buffer, cfg.batch_size, generator=gen)
        dev_ms = device_ms(lambda: sac.update(carry.agent, batch, cfg, generator=gen),
                           reps=15, inner=1)
        h_ms = host_us(lambda: sac.update(carry.agent, batch, cfg, generator=gen),
                       reps=5, inner=10) / 1e3
        upd.setdefault(d, []).append((dev_ms, h_ms))
    ops = {d: update_launches(runs[d][0].agent, replay.sample(runs[d][0].buffer, 256,
                                                              generator=gen), cfgs[d], gen)
           for d in DTYPES}
    for d in DTYPES:
        log(f"[19a] default config in {d}: {N_ENVS} envs x {lp.rollout_steps} steps, "
            f"{seconds[d][0]:.4f} s, {seconds[d][1]:.4f} s per iteration = "
            + ", ".join(f"{N_ENVS * lp.rollout_steps / t:.1f}" for t in seconds[d])
            + " train env steps/s; sac.update at batch 256: device "
            + ", ".join(f"{x[0]:.4f}" for x in upd[d]) + " ms, host "
            + ", ".join(f"{x[1]:.4f}" for x in upd[d])
            + f" ms per call; {ops[d]} device operations per update")
    del runs
    gc.collect()
    torch.cuda.empty_cache()

    rcfg = robust_config()
    r_params, r_loop = build_env_params(rcfg), build_loop_config(rcfg)
    r_loop = dataclasses.replace(r_loop, rollout_steps=BF16_ROBUST_STEPS)
    runs = {}
    for d in DTYPES:
        r_sac = dataclasses.replace(build_sac_config(rcfg), compute_dtype=d)
        carry = loop.init_carry(r_params, r_sac, r_loop, device=dev, seed=SEED + 8)
        carry, _ = loop.make_train_iteration(r_sac, dataclasses.replace(
            r_loop, rollout_steps=WARM_UP_STEPS))(carry, r_params)
        assert carry.buffer.size >= r_sac.learning_starts, carry.buffer.size
        runs[d] = [carry, loop.make_train_iteration(r_sac, r_loop)]
    torch.cuda.synchronize()
    r_seconds, r_launches = timed_in_turns(runs, order, r_params, BF16_ROBUST_STEPS)
    for d in DTYPES:
        log(f"[19a] {ROBUST_YAML} in {d}: {r_loop.num_envs} envs, {r_loop.updates_per_step} "
            f"updates of batch {build_sac_config(rcfg).batch_size} per step: "
            + ", ".join(f"{t / BF16_ROBUST_STEPS * 1e3:.2f}" for t in r_seconds[d])
            + " ms per step")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"bf16_default": launches, "bf16_robust_r4d": r_launches}


HOIST_K = 4                      # [19b] update_interval
HOIST_N, HOIST_STEPS = 256, 16   # [19b] card vs CPU
HOIST_BUFFER = 999_424           # [19b] 61 x 4 x 4096: the capacity the default's 1,000,000 rounds to
SAME_DRAWS = dict(atol=1e-6, rtol=1e-5)   # [19b] hoisted vs per-step cadence on the same draws


def hoisted_card_vs_cpu(dev, short: EnvParams) -> dict:
    """[19b]: ``hoist_bookkeeping=True`` at K = 4, 256 envs x 16 steps,
    learning on, card (K1) against CPU at [7]'s bars; then on the card the
    hoisted iteration against the per-step cadence on the same draws with
    the updates gated off, at SAME_DRAWS. Returns the K1 launches."""
    n_obs = obs_dim(short)
    cfg = sac.SACConfig(**dict(DEFAULT_SAC, buffer_size=32 * HOIST_N,
                               learning_starts=4 * HOIST_N))
    lp = loop.TrainLoopConfig(**dict(DEFAULT_LOOP, num_envs=HOIST_N, rollout_steps=HOIST_STEPS,
                                     update_interval=HOIST_K, hoist_bookkeeping=True),
                              obs_dim=n_obs)
    reset_draws, iter_draws = learner_draws(short, HOIST_N, HOIST_STEPS, cfg,
                                            torch.Generator().manual_seed(SEED + 93))
    runs, launches = {}, {}
    for k, where in (("cpu", torch.device("cpu")), ("card", dev)):
        carry = loop.init_carry(short, cfg, lp, device=where, seed=SEED,
                                reset_draws=to_device(reset_draws, where))
        it = loop.make_train_iteration(cfg, lp)
        assert it.hoisted
        k1.step_kernel.launches = 0
        runs[k] = it(carry, short, to_device(iter_draws, where))
        launches["hoisted_card_vs_cpu"] = k1.step_kernel.launches
    torch.cuda.synchronize()
    (a, am), (b, bm) = runs["card"], runs["cpu"]
    assert launches["hoisted_card_vs_cpu"] == HOIST_STEPS
    torch.testing.assert_close(a.obs.cpu(), b.obs, **OBS)
    for k in ("obs", "next_obs", "action"):
        torch.testing.assert_close(a.buffer.data[k].cpu(), b.buffer.data[k], **OBS, msg=k)
    torch.testing.assert_close(a.buffer.data["reward"].cpu(), b.buffer.data["reward"], **REWARD)
    assert torch.equal(a.buffer.data["done"].cpu(), b.buffer.data["done"]), "terminated differs"
    for name in ("episodes", "successes", "ep_length", "ep_ring_length", "ep_ring_seq",
                 "ep_ring_ptr"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), f"{name} differs"
    for name in ("ep_return", "return_sum", "ep_ring_return"):
        torch.testing.assert_close(getattr(a, name).cpu(), getattr(b, name), **REWARD, msg=name)
    for k in bm:
        torch.testing.assert_close(am[k].cpu(), bm[k], **METRICS, msg=k)
    events = HOIST_STEPS // HOIST_K
    assert a.agent.step == b.agent.step == events, (a.agent.step, b.agent.step)
    param_err = max(net_param_err(getattr(a.agent, net), getattr(b.agent, net), net)
                    for net in ("actor", "critic", "target_critic"))
    torch.testing.assert_close(a.agent.log_alpha.cpu(), b.agent.log_alpha, **PARAMS)
    log(f"[19b] hoisted iteration K = {HOIST_K}, {HOIST_N} envs x {HOIST_STEPS} steps, "
        f"{events} update events, card (K1) vs CPU: max |d obs| "
        f"{float((a.obs.cpu() - b.obs).abs().max()):.3e}, episode ends and ring equal "
        f"({int(b.episodes.sum())} episode ends), max |d param| {param_err:.3e} (atol "
        f"{PARAMS['atol']}): ok")

    gated = dataclasses.replace(cfg, learning_starts=10**9)
    out = {}
    k1.step_kernel.launches = 0
    for hoist in (True, None):
        carry = loop.init_carry(short, gated, lp, device=dev, seed=SEED,
                                reset_draws=to_device(reset_draws, dev))
        it = loop.make_train_iteration(gated, dataclasses.replace(lp, hoist_bookkeeping=hoist))
        assert it.hoisted == bool(hoist)
        out[bool(hoist)] = it(carry, short, to_device(iter_draws, dev))
    torch.cuda.synchronize()
    launches["hoisted_vs_cadence"] = k1.step_kernel.launches
    (h, hm), (c, cm) = out[True], out[False]
    worst = 0.0
    pairs = [("obs", h.obs, c.obs)] + [(f"buffer.{k}", h.buffer.data[k], c.buffer.data[k])
                                        for k in h.buffer.data]
    pairs += [(name, getattr(h, name), getattr(c, name)) for name in (
        "env_steps", "episodes", "successes", "ep_return", "ep_length", "return_sum",
        "length_sum", "ep_ring_return", "ep_ring_length", "ep_ring_success", "ep_ring_seq",
        "ep_ring_ptr")]
    pairs += [(k, hm[k], cm[k]) for k in ("reward_mean", "done_frac")]
    for name, x, y in pairs:
        assert x.dtype == y.dtype, name
        torch.testing.assert_close(x.double(), y.double(), **SAME_DRAWS, msg=name)
        worst = max(worst, float((x.double() - y.double()).abs().max()))
    assert h.agent.step == c.agent.step == 0 and launches["hoisted_vs_cadence"] == 2 * HOIST_STEPS
    log(f"[19b] hoisted vs per-step cadence on the card, same draws, updates gated off: max |d| "
        f"{worst:.3e} over obs, replay rows, counters, ring and metrics (atol "
        f"{SAME_DRAWS['atol']}, rtol {SAME_DRAWS['rtol']}): ok")
    return launches


def hoisted_full_width(dev, env_params: EnvParams) -> dict:
    """[19b]: the default configuration with ``update_interval`` 4 and
    ``buffer_size`` HOIST_BUFFER, per-step cadence and hoisted in turns (A B
    B A, one synchronised 128-step iteration each): ms per env step; then one
    profiled chunk of each (device busy, idle and operations per env step).
    Returns the K1 launches of the timed runs."""
    n_obs = obs_dim(env_params)
    cfg = sac.SACConfig(**dict(DEFAULT_SAC, buffer_size=HOIST_BUFFER))
    base = loop.TrainLoopConfig(**dict(DEFAULT_LOOP, update_interval=HOIST_K), obs_dim=n_obs)
    paths = {"per-step": dataclasses.replace(base, hoist_bookkeeping=None),
             "hoisted": dataclasses.replace(base, hoist_bookkeeping=True)}
    runs = {}
    for name, lp in paths.items():
        carry = loop.init_carry(env_params, cfg, lp, device=dev, seed=SEED + 6)
        assert carry.buffer.capacity == HOIST_BUFFER, carry.buffer.capacity
        carry, _ = loop.make_train_iteration(cfg, dataclasses.replace(
            lp, rollout_steps=WARM_UP_STEPS))(carry, env_params)
        it = loop.make_train_iteration(cfg, lp)
        assert it.hoisted == (name == "hoisted")
        runs[name] = [carry, it]
    torch.cuda.synchronize()
    order = ("per-step", "hoisted", "hoisted", "per-step")
    seconds, launches = timed_in_turns(runs, order, env_params, base.rollout_steps)
    for name, lp in paths.items():
        chunk = loop.make_train_iteration(cfg, dataclasses.replace(lp, rollout_steps=HOIST_K))
        carry = runs[name][0]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            carry, _ = chunk(carry, env_params)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / HOIST_K * 1e3
        runs[name][0] = carry
        log(f"[19b] {name} at K = {HOIST_K}, default config: "
            + ", ".join(f"{t / base.rollout_steps * 1e3:.4f}" for t in seconds[name])
            + f" ms per env step over {base.rollout_steps}-step iterations")
        device_breakdown(prof, HOIST_K, step_ms, "[19b]",
                         f"{name}, one profiled chunk of {HOIST_K} steps ({N_ENVS} envs)", top=5)
        del prof
        gc.collect()
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"hoisted_default": launches}


# [20] the JAX package's msgpack fixtures (tests/test_torch_jax_artifacts.py
# writes them; manifest.json names their widths)
JAX_FIXTURES = ROOT / "tests" / "fixtures" / "jax_msgpack"
JAX_FIXTURE_ATOL = 1e-5          # the card's outputs against the JAX package's (TF32 off)
JAX_FT_STEPS = 2                 # [20] the warm-started trainer's rollout_steps, one iteration


def jax_artifacts_on_card(scratch: Path, dev) -> dict:
    """[20]: the JAX package's flax msgpack files through the port's entry
    points on the card: the default-width legacy ``SACAgent.save`` file
    (``SACAgent.load``, ``load_agent_state``), a DAgger student
    (``load_agent_state``), a θ-student (``policy_breakdown.load_policy``)
    and an ensemble checkpoint (``MultiAlgorithmAgent.load_checkpoint``),
    each one's outputs on 64 fixed observations held against the JAX
    package's (``expected.npz``) at ``JAX_FIXTURE_ATOL``; the decoder's host
    ms per MB; then the three suites at their defaults on the legacy policy
    and a default-config ``Trainer`` warm-started from the student for one
    ``JAX_FT_STEPS``-step iteration, both through K1. Returns their K1
    launches."""
    from tvc_ai_torch import policy_breakdown
    from tvc_ai_torch.agents.legacy import SACAgent
    from tvc_ai_torch.utils import flax_msgpack

    manifest = json.loads((JAX_FIXTURES / "manifest.json").read_text())
    with np.load(JAX_FIXTURES / "expected.npz") as npz:
        expected = dict(npz)
    files = [JAX_FIXTURES / spec["file"] for spec in manifest.values()]
    t0 = time.perf_counter()
    for path in files:
        flax_msgpack.load(path)
    decode_s = time.perf_counter() - t0
    mb = sum(p.stat().st_size for p in files) / 2**20
    log(f"[20] decoded {len(files)} flax msgpack files, {mb:.3f} MB, in {decode_s * 1e3:.2f} ms "
        f"of host = {decode_s * 1e3 / mb:.3f} ms per MB")

    def on_card(name: str) -> torch.Tensor:
        return torch.from_numpy(expected[name]).to(dev)

    def held(name: str, got: torch.Tensor, what: str) -> float:
        err = float((got.float().cpu() - torch.from_numpy(expected[name])).abs().max())
        assert err <= JAX_FIXTURE_ATOL, (what, err)
        log(f"[20] {what}: max |card - JAX| {err:.3e} (atol {JAX_FIXTURE_ATOL}): ok")
        return err

    def actions(actor, name: str) -> torch.Tensor:
        return sac.select_action(actor, on_card(name), deterministic=True)

    errs = []
    spec = manifest["legacy"]
    cfg_legacy = sac.SACConfig(tuple(spec["hidden_dims"]))
    path = JAX_FIXTURES / spec["file"]
    agent = SACAgent(spec["obs_dim"], 2, cfg_legacy, device=dev)
    agent.load(path)
    assert agent.total_steps == spec["total_steps"], agent.total_steps
    errs.append(held("legacy_actions", actions(agent.actor, "legacy_obs"),
                     f"legacy SACAgent.save ({spec['hidden_dims']}) through SACAgent.load"))
    legacy_state = load_agent_state(path, spec["obs_dim"], 2, cfg_legacy, dev)
    errs.append(held("legacy_actions", actions(legacy_state.actor, "legacy_obs"),
                     "the same file through load_agent_state"))
    spec = manifest["student"]
    student_path = JAX_FIXTURES / spec["file"]
    student = load_agent_state(student_path, spec["obs_dim"] * spec["history_len"], 2,
                               sac.SACConfig(tuple(spec["hidden_dims"])), dev)
    errs.append(held("student_actions", actions(student.actor, "student_obs"),
                     f"DAgger student ({spec['hidden_dims']}) through load_agent_state"))
    spec = manifest["theta"]
    suite = policy_breakdown.suite_params("robustness", False, "ema")
    _, net = policy_breakdown.load_policy(JAX_FIXTURES / spec["file"], suite,
                                          spec["history_len"], [], dev)
    with torch.no_grad():
        errs.append(held("theta_out", net(on_card("theta_obs")),
                         f"θ-student ({spec['hidden_dims']}) through policy_breakdown"))
    spec = manifest["ensemble"]
    widths = tuple(spec["hidden_dims"])
    ens_cfg = ensemble.EnsembleConfig(sac=sac.SACConfig(widths), td3=td3.TD3Config(widths),
                                      ppo=ppo.PPOConfig(widths))
    ens = ensemble.MultiAlgorithmAgent(config=ens_cfg, device=dev)
    ens.attach_carry(ensemble.init_carry(EnvParams(), ens_cfg, 4, device=dev, seed=SEED))
    ens.load_checkpoint(JAX_FIXTURES / spec["file"])
    assert {a: list(h) for a, h in ens.performance_history.items()} == \
        spec["performance_history"]
    assert ens.algorithm_weights == spec["algorithm_weights"]
    for algo in ("sac", "td3", "ppo"):
        got, _ = ens.get_action(expected["ensemble_obs"], deterministic=True, algorithm=algo)
        errs.append(held(f"ensemble_{algo}", torch.from_numpy(got),
                         f"ensemble {algo} member ({spec['hidden_dims']}) through "
                         "load_checkpoint (windows and weights equal)"))

    launches = {}
    out_dir = scratch / "jax_suites"
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    results = run_all_suites(legacy_state, cfg_legacy, out_dir, seed=SEED, device=dev)
    wall = time.perf_counter() - t0
    launches["jax_suites"] = k1.step_kernel.launches
    assert launches["jax_suites"] == sum(r.steps for r in results.values()), launches
    for name, r in results.items():
        assert all(math.isfinite(v) for v in r.metrics.values()), (name, r.metrics)
    log(f"[20] run_all_suites on the JAX legacy policy (256x256): "
        + ", ".join(f"{name} {r.stats.returns.shape[0]} episodes x {r.steps} steps, success "
                    f"{r.metrics['eval_success_rate']:.3f}" for name, r in results.items())
        + f"; {wall:.3f} s, K1 launches {launches['jax_suites']} == steps run")

    spec = manifest["student"]
    cfg = load_config(None, [f"algorithms.sac.hidden_dims=[{widths[0]},{widths[1]}]",
                             f"training.rollout_steps={JAX_FT_STEPS}",
                             f"network.history_len={spec['history_len']}",
                             "logging.tensorboard=false",
                             f"training.warm_start_actor={student_path}"])
    cfg.training.total_timesteps = cfg.training.num_envs * JAX_FT_STEPS
    tr = Trainer(cfg, output_dir=scratch / "jax_student_ft", device=dev)
    errs.append(held("student_actions", actions(tr.carry.agent.actor, "student_obs"),
                     "Trainer actor warm-started from the JAX student"))
    evals: list = []
    counting_evals(tr, evals)
    k1.step_kernel.launches = 0
    result = tr.train()
    launches["jax_student_ft"] = k1.step_kernel.launches
    assert result["iterations"] == 1 and launches["jax_student_ft"] == (
        JAX_FT_STEPS + sum(k for k, _, _ in evals)), (result["iterations"], launches, evals)
    train_s = result["stage_timing"]["train_iteration"]["total_sec"]
    log(f"[20] default-config Trainer ({cfg.training.num_envs} envs x {JAX_FT_STEPS} steps) "
        f"warm-started from the JAX student: {train_s:.4f} s of training, eval success "
        f"{result['eval_success_rate']:.3f}; K1 launches {launches['jax_student_ft']}")
    tr.logger.close()
    log(f"[20] every fixture held; max |card - JAX| {max(errs):.3e}")
    return launches


# [21] the JAX trainer's orbax checkpoint (tests/test_torch_orbax.py writes it;
# manifest.json names its config overrides and each carry leaf's SHA-256)
JAX_ORBAX = ROOT / "tests" / "fixtures" / "jax_orbax"


def orbax_leaves(tree, prefix: tuple = ()):
    """(dotted key path, leaf) of every non-None leaf of an orbax tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from orbax_leaves(v, prefix + (str(k),))
    elif isinstance(tree, tuple):
        for i, v in enumerate(tree):
            yield from orbax_leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield ".".join(prefix), tree


def leaf_sha256(leaf) -> str:
    if isinstance(leaf, torch.Tensor):   # bfloat16
        return hashlib.sha256(leaf.contiguous().view(torch.int16).numpy().tobytes()).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(leaf).tobytes()).hexdigest()


def timed_decode(ckpts, step: int, prefix: tuple, what: str, tag: str = "[21]"
                 ) -> tuple[dict, float]:
    """Decode ``prefix`` of ``step`` and print its MB, ms and MB/s."""
    t0 = time.perf_counter()
    tree = ckpts.read(step, prefix=prefix)
    seconds = time.perf_counter() - t0
    mb = sum(leaf.nbytes for _, leaf in orbax_leaves(tree)) / 2**20
    log(f"{tag} decoded {what}: {mb:.3f} MB of arrays in {seconds * 1e3:.2f} ms of host = "
        f"{mb / seconds:.3f} MB/s")
    return tree, seconds


def jax_orbax_on_card(scratch: Path, dev) -> dict:
    """[21]: the JAX trainer's orbax checkpoint through the port's reader and
    entry points on the card: the agent and the whole carry decoded (MB, ms
    and MB/s of each), every carry leaf's SHA-256 held exactly, the actions
    and twin Q of ``load_agent_state(<step dir>)`` held against the JAX
    package's at ``JAX_FIXTURE_ATOL``; then the three suites on that agent
    and a default-config ``Trainer`` resumed from the checkpoint for one
    2-step iteration, both through K1. Returns their K1 launches."""
    from tvc_ai_torch.utils.orbax_read import OrbaxCheckpoints

    t_phase = time.perf_counter()
    manifest = json.loads((JAX_ORBAX / "manifest.json").read_text())
    with np.load(JAX_ORBAX / "expected.npz") as npz:
        expected = dict(npz)
    root = JAX_ORBAX / "checkpoints"
    step = manifest["step"]
    ckpts = OrbaxCheckpoints(root)
    assert ckpts.latest_step() == step, ckpts.all_steps()
    log(f"[21] fixture: step {step}, {dir_bytes(root / str(step)) / 2**20:.3f} MB on disk")
    timed_decode(ckpts, step, ("agent",), "the agent (carry/agent)")
    carry, _ = timed_decode(ckpts, step, (), "the whole carry (replay ring included)")
    sums = {path: leaf_sha256(leaf) for path, leaf in orbax_leaves(carry)}
    bad = sorted(p for p in set(sums) | set(manifest["leaves"])
                 if sums.get(p) != manifest["leaves"].get(p))
    assert not bad, bad[:10]
    assert carry["buffer"]["data"]["obs"].shape[0] == manifest["buffer_rows"]
    log(f"[21] every carry leaf's SHA-256 equal to the JAX package's: {len(sums)} leaves")

    cfg = load_config(None, manifest["overrides"])
    sac_cfg = build_sac_config(cfg)
    obs = torch.from_numpy(expected["obs"]).to(dev)

    def held(agent, what: str) -> float:
        with torch.no_grad():
            actions = sac.select_action(agent.actor, obs, deterministic=True)
            q1, q2 = agent.critic(obs, actions)
        err = max(float((got.float().cpu() - torch.from_numpy(expected[name])).abs().max())
                  for name, got in (("actions", actions), ("q1", q1), ("q2", q2)))
        assert err <= JAX_FIXTURE_ATOL, (what, err)
        log(f"[21] {what}: actions and twin Q max |card - JAX| {err:.3e} "
            f"(atol {JAX_FIXTURE_ATOL}): ok")
        return err

    state = load_agent_state(root / str(step), manifest["obs_dim"], 2, sac_cfg, dev)
    errs = [held(state, f"load_agent_state(<step dir>) ({manifest['hidden_dims']})")]

    launches = {}
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    results = run_all_suites(state, sac_cfg, scratch / "orbax_suites", seed=SEED, device=dev)
    wall = time.perf_counter() - t0
    launches["orbax_suites"] = k1.step_kernel.launches
    assert launches["orbax_suites"] == sum(r.steps for r in results.values()), launches
    for name, r in results.items():
        assert all(math.isfinite(v) for v in r.metrics.values()), (name, r.metrics)
    log("[21] run_all_suites on the JAX trainer's agent: "
        + ", ".join(f"{name} {r.stats.returns.shape[0]} episodes x {r.steps} steps, success "
                    f"{r.metrics['eval_success_rate']:.3f}" for name, r in results.items())
        + f"; {wall:.3f} s, K1 launches {launches['orbax_suites']} == steps run")

    t0 = time.perf_counter()
    tr = Trainer(cfg, output_dir=scratch / "orbax_resume", resume=root, device=dev)
    resume_s = time.perf_counter() - t0
    assert tr.iteration == 1 and tr.env_steps == step, (tr.iteration, tr.env_steps)
    assert tr.carry.buffer.size == manifest["buffer_size"], tr.carry.buffer.size
    assert torch.equal(tr.carry.buffer.data["obs"].cpu(),
                       torch.tensor(carry["buffer"]["data"]["obs"]))
    errs.append(held(tr.carry.agent, "the resumed Trainer's agent"))
    evals: list = []
    counting_evals(tr, evals)
    tr.cfg.training.total_timesteps = step + cfg.training.num_envs * cfg.training.rollout_steps
    k1.step_kernel.launches = 0
    result = tr.train()
    launches["orbax_resume"] = k1.step_kernel.launches
    assert result["iterations"] == 2 and launches["orbax_resume"] == (
        cfg.training.rollout_steps + sum(k for k, _, _ in evals)), (result["iterations"],
                                                                    launches, evals)
    train_s = result["stage_timing"]["train_iteration"]["total_sec"]
    log(f"[21] default-config Trainer resumed from the orbax root in {resume_s:.3f} s "
        f"(Trainer construction included), then one {cfg.training.num_envs} envs x "
        f"{cfg.training.rollout_steps} steps iteration: {train_s:.4f} s of training, eval "
        f"success {result['eval_success_rate']:.3f}; K1 launches {launches['orbax_resume']}")
    tr.logger.close()
    log(f"[21] every check held; max |card - JAX| {max(errs):.3e}; the phase took "
        f"{time.perf_counter() - t_phase:.3f} s")
    return launches


# ---------------------------------------------------------------- 22. sharded orbax checkpoints
JAX_ORBAX_MESH2 = ROOT / "tests" / "fixtures" / "jax_orbax_mesh2"


def mesh2_held_paths(manifest: dict) -> list[str]:
    """The leaves [22] holds in a resumed carry against the manifest: every
    leaf but the agent's (held through its outputs in [21]) and the JAX keys
    (dropped by the port)."""
    return [p for p in manifest["shards"][0]
            if not p.startswith(("agent.", "env_states.key")) and p != "key"]


def resumed_leaf_sums(carry, paths: list[str]) -> dict[str, str]:
    """The SHA-256 of each JAX leaf path's counterpart in a port carry (the
    port's fields keep the JAX package's names; ``ptr`` and ``size`` are
    host ints, hashed as the int32 the JAX package stores)."""
    sums = {}
    for path in paths:
        node = carry
        for part in path.split("."):
            node = node[part] if isinstance(node, dict) else getattr(node, part)
        sums[path] = leaf_sha256(node.cpu().numpy() if isinstance(node, torch.Tensor)
                                 else np.asarray(node, np.int32))
    return sums


def train_resumed(tr, step: int) -> tuple[dict, int, list, float]:
    """One iteration and the eval round of a resumed trainer, with K1's
    count set to 0 just before: (result, launches, evals, seconds)."""
    evals: list = []
    counting_evals(tr, evals)
    tr.cfg.training.total_timesteps = step + tr.loop_cfg.num_envs * tr.loop_cfg.rollout_steps
    mesh.barrier()
    k1.step_kernel.launches = 0
    t0 = time.perf_counter()
    result = tr.train()
    seconds = time.perf_counter() - t0
    launches = k1.step_kernel.launches
    assert result["iterations"] == 2 and math.isfinite(result["eval_success_rate"]), result
    assert launches == tr.loop_cfg.rollout_steps + sum(n for n, _, _ in evals), (launches, evals)
    return result, launches, evals, seconds


def orbax_mesh_rank(rank: int, dev, root: Path, side: str) -> None:
    """[22] on one rank of world 2 (gloo, both ranks on the one card): the
    mesh-2 fixture resumed, the rank's carry held against its shard's
    SHA-256s before training, then one 2-step iteration and the eval round
    (rank 0 evaluates)."""
    manifest = json.loads((JAX_ORBAX_MESH2 / "manifest.json").read_text())
    cfg = load_config(None, [*manifest["overrides"], f"globals.output_dir={root}"])
    t0 = time.perf_counter()
    tr = Trainer(cfg, output_dir=root / "run", resume=JAX_ORBAX_MESH2 / "checkpoints", device=dev)
    resume_s = time.perf_counter() - t0
    assert tr.world == DP_WORLD and tr.rank == rank, (tr.world, tr.rank)
    sums = resumed_leaf_sums(tr.carry, mesh2_held_paths(manifest))
    bad = sorted(p for p, h in sums.items() if h != manifest["shards"][rank][p])
    result, launches, evals, train_s = train_resumed(tr, manifest["step"])
    torch.save({"bad": bad, "held": len(sums), "envs": tr.carry.obs.shape[0],
                "rows": tr.carry.buffer.capacity, "resume_s": resume_s, "train_s": train_s,
                "launches": launches, "eval_steps": sum(ran for _, ran, _ in evals),
                "env_steps": result["env_steps"], "success": result["eval_success_rate"]},
               root / f"{side}{rank}.pt")
    tr.logger.close()


def jax_orbax_mesh_on_card(scratch: Path, dev) -> dict:
    """[22]: the JAX trainer's checkpoint written at
    ``hardware.mesh_devices=2`` (``tests/fixtures/jax_orbax_mesh2``): decoded
    by the port's reader with every leaf's SHA-256 held; resumed at world 2
    (two gloo ranks on the one card), each rank's carry held against its
    shard's SHA-256s; resumed at world 1, the replay re-laid in global step
    blocks (held against the explicit permutation of the decoded rows) with
    ``ptr`` and ``size`` doubled and the env rows in global order; each
    resume then trains one 2-step iteration and runs the eval round through
    K1. Returns the K1 launches of each rank and of world 1."""
    from tvc_ai_torch.utils.orbax_read import OrbaxCheckpoints

    t_phase = time.perf_counter()
    manifest = json.loads((JAX_ORBAX_MESH2 / "manifest.json").read_text())
    root = JAX_ORBAX_MESH2 / "checkpoints"
    step, n = manifest["step"], manifest["num_envs"]
    ckpts = OrbaxCheckpoints(root)
    assert ckpts.latest_step() == step, ckpts.all_steps()
    carry, decode_s = timed_decode(ckpts, step, (), "the mesh-2 carry (both shards)", "[22]")
    sums = {path: leaf_sha256(leaf) for path, leaf in orbax_leaves(carry)}
    bad = sorted(p for p in set(sums) | set(manifest["leaves"])
                 if sums.get(p) != manifest["leaves"].get(p))
    assert not bad, bad[:10]
    assert mesh.jax_carry_shards(carry) == manifest["devices"] == DP_WORLD
    log(f"[22] fixture: step {step}, {dir_bytes(root / str(step)) / 2**20:.3f} MB on disk, "
        f"{manifest['devices']} shards; every leaf's SHA-256 equal to the JAX package's: "
        f"{len(sums)} leaves")

    launches = {}
    run_ranks("orbax_mesh", DP_WORLD, scratch / "orbax_mesh2")
    ranks = [torch.load(scratch / "orbax_mesh2" / f"cuda{r}.pt", weights_only=False)
             for r in range(DP_WORLD)]
    for r, row in enumerate(ranks):
        assert not row["bad"], (r, row["bad"][:10])
        assert row["envs"] == n // DP_WORLD and row["env_steps"] == step + n * 2, row
        launches[f"orbax_mesh2_rank{r}"] = row["launches"]
        log(f"[22] world 2, rank {r}: resumed in {row['resume_s']:.3f} s (Trainer construction "
            f"and its own decode included); {row['held']} leaves' SHA-256 equal to shard {r}'s "
            f"({row['envs']} envs, {row['rows']} replay rows); one iteration + eval round in "
            f"{row['train_s']:.3f} s, eval success {row['success']:.3f}; K1 launches "
            f"{row['launches']} ({row['eval_steps']} eval steps)")

    cfg = load_config(None, [*manifest["overrides"], "hardware.mesh_devices=1"])
    t0 = time.perf_counter()
    tr = Trainer(cfg, output_dir=scratch / "orbax_mesh_w1", resume=root, device=dev)
    resume_s = time.perf_counter() - t0
    buf, rows = tr.carry.buffer, manifest["buffer_rows"]
    assert (buf.ptr, buf.size) == (2 * manifest["buffer_ptr"], 2 * manifest["buffer_size"])
    g = np.arange(rows)
    block, env, local = g // n, g % n, n // DP_WORLD
    perm = env // local * (rows // DP_WORLD) + block * local + env % local
    for k, v in carry["buffer"]["data"].items():
        assert torch.equal(buf.data[k].cpu(), torch.from_numpy(np.ascontiguousarray(v[perm]))), k
    assert torch.equal(tr.carry.obs.cpu(), torch.from_numpy(carry["obs"]))
    assert tr.carry.ep_ring_seq.shape[0] == manifest["ring_size"]
    result, launches["orbax_mesh2_world1"], evals, train_s = train_resumed(tr, step)
    log(f"[22] world 1: resumed in {resume_s:.3f} s; replay re-laid in {rows // n} global step "
        f"blocks equal to the permuted decoded rows, ptr {buf.ptr} and size {buf.size} (2 x the "
        f"shards'); one iteration + eval round in {train_s:.3f} s, eval success "
        f"{result['eval_success_rate']:.3f}; K1 launches {launches['orbax_mesh2_world1']}")
    tr.logger.close()
    del tr
    gc.collect()
    log(f"[22] decode {decode_s * 1e3:.2f} ms; K1 launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items())
        + f"; the phase took {time.perf_counter() - t_phase:.3f} s")
    return launches


def k1_below_one_block(gen, dev, params: RocketParams, errs: list) -> dict:
    """[9a]: K1 against its plain version below one block, at N = 1 (the
    single-env path of [17], in contact too), 2, 20 and 50, each N's time
    beside the launch floor on its grid. Appends the errors to ``errs``;
    returns {N: (ms, floor ms)}."""
    small_n = {}
    # N = 1 (the single-env path, [17]) in contact too: one env tipped 0.1
    # rad, its lower end 4.75 cm into the ground
    state, ctrl, dr = random_physics_batch(1, gen, dev, ground=True)
    state.pos[0, 2] = 0.45
    state.quat[0] = torch.tensor([math.sin(0.05), 0.0, 0.0, math.cos(0.05)], device=dev)
    out = k1.step_kernel(state, ctrl, params, *dr)
    ref = integrator.step(state, ctrl, params, *dr)
    torch.cuda.synchronize()
    assert_body_close(out, ref, CONTACT, "K1 n=1 contact")
    errs.append(max_abs_diff(out, ref))
    log(f"[9a] K1 n=1 in contact: max |K1 - plain| = {errs[-1]:.3e} (atol {CONTACT['atol']}, "
        f"rtol {CONTACT['rtol']}) ok")
    for n, tol in ((1, FLIGHT), (2, FLIGHT), (20, FLIGHT), (50, FLIGHT)):
        state, ctrl, dr = random_physics_batch(n, gen, dev, clear=True)
        out = k1.step_kernel(state, ctrl, params, *dr)
        ref = integrator.step(state, ctrl, params, *dr)
        torch.cuda.synchronize()
        assert_body_close(out, ref, tol, f"K1 n={n}")
        errs.append(max_abs_diff(out, ref))
        small_n[n] = (device_ms(lambda: k1.step_kernel(state, ctrl, params, *dr)),
                      device_ms(lambda: k1.launch_floor(n, dev)))
        log(f"[9a] K1 n={n}: max |K1 - plain| = {errs[-1]:.3e} (atol {tol['atol']}, rtol "
            f"{tol['rtol']}) ok; {small_n[n][0]:.5f} ms, launch floor {small_n[n][1]:.5f} ms")
    return small_n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", action="append", default=[], type=Path, metavar="DIR",
                    help="root of another checkout whose K1 phase [6] times in turns with this one")
    ap.add_argument("--cem-parting", type=int, default=0, metavar="N",
                    help="build K1, then only run [16b]'s card-vs-CPU check on N seeds")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    dev = torch.device("cuda", 0)
    native_before = native_fingerprint()
    set_parity_precision()
    smi = nvidia_smi_line()
    log(f"[1] nvidia-smi: {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    # the config and trainer slice reads YAML: record whether this machine can
    try:
        import yaml
        yaml_status = f"importable (PyYAML {yaml.__version__})"
    except ImportError as exc:
        yaml_status = f"not importable ({exc})"
    log(f"[1] PyYAML: {yaml_status}")

    phase("[2]")
    # ---- 2. build K1 from the checkout's sources
    t0 = time.perf_counter()
    lib, build_log = k1.build()
    log(f"[2] built {lib.name} in {time.perf_counter() - t0:.2f} s")
    for line in build_log.strip().splitlines():
        log(f"[2] nvcc: {line.strip()}")
    if args.cem_parting:
        return cem_parting(dev, args.cem_parting)

    phase("[3]")
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
        states, obs = rocket_env.reset(short, small, device=where,
                                       draws=to_device(reset_draws, where))
        actor = sac.make_actor(n_obs, 2, sac.SACConfig(HIDDEN), device=where, seed=SEED)
        runs[where] = collect(actor, states, obs, short, steps, draws=to_device(draws, where))
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

    phase("[4]")
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

    phase("[5]")
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
    device_breakdown(prof, PROFILE_STEPS, prof_ms, "[5b]",
                     f"profiled collect, {N_ENVS} envs x {PROFILE_STEPS} steps")
    # the trace's ~1e5 event objects would make every later garbage collection
    # slow, and with it the host time [6] measures
    del prof
    gc.collect()

    phase("[6]")
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

    phase("[7]")
    # ---- 7. the learner on the card (K1) against the port on the CPU (plain
    # version): the same initial state and draws, 16 steps, updates from step 4
    short_sac = sac.SACConfig(**dict(DEFAULT_SAC, buffer_size=32 * small,
                                     learning_starts=4 * small))
    short_loop = loop.TrainLoopConfig(**dict(DEFAULT_LOOP, num_envs=small, rollout_steps=steps),
                                      obs_dim=n_obs)
    reset_draws, iter_draws = learner_draws(short, small, steps, short_sac,
                                            torch.Generator().manual_seed(SEED + 5))
    learned = {}
    for where in ("cpu", "cuda"):
        carry = loop.init_carry(short, short_sac, short_loop, device=where, seed=SEED,
                                reset_draws=to_device(reset_draws, where))
        it = loop.make_train_iteration(short_sac, short_loop)
        learned[where] = it(carry, short, to_device(iter_draws, where))
    torch.cuda.synchronize()
    (a, am), (b, bm) = learned["cuda"], learned["cpu"]
    n_updates = sum(1 for d in iter_draws if d.samples)
    assert a.agent.step == b.agent.step == n_updates > 0, (a.agent.step, b.agent.step)
    torch.testing.assert_close(a.obs.cpu(), b.obs, **OBS)
    for k in ("obs", "next_obs", "action"):
        torch.testing.assert_close(a.buffer.data[k].cpu(), b.buffer.data[k], **OBS, msg=k)
    torch.testing.assert_close(a.buffer.data["reward"].cpu(), b.buffer.data["reward"], **REWARD)
    assert torch.equal(a.buffer.data["done"].cpu(), b.buffer.data["done"]), "terminated differs"
    for name in ("episodes", "ep_length", "ep_ring_seq", "ep_ring_ptr"):
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name)), f"{name} differs"
    assert torch.equal(a.env_states.step_count.cpu(), b.env_states.step_count), "truncation"
    for k in bm:
        torch.testing.assert_close(am[k].cpu(), bm[k], **METRICS, msg=k)
    param_err = 0.0
    for net in ("actor", "critic", "target_critic"):
        for (name, p), q in zip(getattr(a.agent, net).named_parameters(),
                                getattr(b.agent, net).parameters()):
            torch.testing.assert_close(p.detach().cpu(), q.detach(), **PARAMS, msg=f"{net}.{name}")
            param_err = max(param_err, float((p.detach().cpu() - q.detach()).abs().max()))
    torch.testing.assert_close(a.agent.log_alpha.cpu(), b.agent.log_alpha, **PARAMS)
    n_done = int(b.episodes.sum())
    assert n_done >= small, "no autoreset fired in the learner check"
    log(f"[7] train iteration {small} envs x {steps} steps, {n_updates} updates, card (K1) vs "
        f"CPU (plain): max |d obs| {float((a.obs.cpu() - b.obs).abs().max()):.3e}, max |d "
        f"replay reward| "
        f"{float((a.buffer.data['reward'].cpu() - b.buffer.data['reward']).abs().max()):.3e}, "
        f"terminations and episode ends equal ({n_done} episode ends), max |d param| "
        f"{param_err:.3e} (atol {PARAMS['atol']}), critic_loss {float(am['critic_loss']):.6g} "
        f"vs {float(bm['critic_loss']):.6g}: ok")
    del learned, a, b, am, bm, iter_draws

    phase("[8]")
    # ---- 8. the main path: the fused train iteration at the default
    # configuration, K1 for the physics, learning on from the first step
    train_sac = sac.SACConfig(**DEFAULT_SAC)
    train_loop = loop.TrainLoopConfig(**DEFAULT_LOOP, obs_dim=n_obs)
    steps_per_iter = train_loop.rollout_steps
    carry = loop.init_carry(env_params, train_sac, train_loop, device=dev, seed=SEED + 6)
    capacity = carry.buffer.capacity
    train_it = loop.make_train_iteration(train_sac, train_loop)
    t0 = time.perf_counter()
    carry, metrics = train_it(carry, env_params)   # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    assert carry.buffer.size == steps_per_iter * N_ENVS, carry.buffer.size
    assert carry.agent.step == steps_per_iter, carry.agent.step
    k1.step_kernel.launches = 0
    iter_s = []
    for i in range(2):
        step0 = carry.agent.step
        t0 = time.perf_counter()
        carry, metrics = train_it(carry, env_params)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t0)
        assert carry.agent.step - step0 == steps_per_iter, carry.agent.step - step0
        if i == 0:   # the ring has wrapped
            assert (carry.buffer.size, carry.buffer.ptr) == (
                capacity, 2 * steps_per_iter * N_ENVS - capacity), (carry.buffer.size,
                                                                  carry.buffer.ptr)
    train_launches = k1.step_kernel.launches
    assert train_launches == 2 * steps_per_iter, (train_launches, 2 * steps_per_iter)
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        carry, metrics = train_it(carry, env_params)
        sync_free_ms = (time.perf_counter() - t0) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    agent = carry.agent
    params_finite = all(bool(torch.isfinite(p).all()) for net in (agent.actor, agent.critic,
                                                                  agent.target_critic)
                        for p in net.parameters())
    losses = {k: float(v) for k, v in metrics.items()}
    assert params_finite and all(map(math.isfinite, losses.values())), losses
    assert losses["alpha"] > 0.0, losses
    assert any(not torch.equal(p, q) for p, q in zip(agent.critic.parameters(),
                                                     agent.target_critic.parameters()))
    updates_per_s = len(iter_s) * steps_per_iter * train_loop.updates_per_step / sum(iter_s)
    log(f"[8] train iteration (default config): {N_ENVS} envs x {steps_per_iter} steps, "
        f"{train_loop.updates_per_step} update per step at batch {train_sac.batch_size}, replay "
        f"capacity {capacity} ({sum(t.numel() * t.element_size() for t in carry.buffer.data.values()) / 1e6:.1f} MB); "
        f"warm-up {warm_s:.3f} s; timed {iter_s[0]:.4f} s, {iter_s[1]:.4f} s per iteration = "
        f"{N_ENVS * steps_per_iter / iter_s[0]:.1f}, {N_ENVS * steps_per_iter / iter_s[1]:.1f} "
        f"train env steps/s with learning on ({iter_s[0] / steps_per_iter * 1e3:.3f}, "
        f"{iter_s[1] / steps_per_iter * 1e3:.3f} ms per env step); "
        f"{updates_per_s:.1f} SAC updates/s over both timed iterations; K1 launches {train_launches} == "
        f"env steps taken")
    log(f"[8] under set_sync_debug_mode('error'): one iteration enqueued in {sync_free_ms:.1f} "
        f"ms with no host-device synchronisation; buffer size {carry.buffer.size}, ptr "
        f"{carry.buffer.ptr}; updates {agent.step}; metrics "
        + ", ".join(f"{k} {v:.5g}" for k, v in losses.items()) + "; params finite, alpha > 0, "
        "target != online critic: ok")

    # ---- 8b. where the time of a train step goes: 16 steps under the profiler,
    # then one SAC update and one replay write + sample alone
    prof_it = loop.make_train_iteration(
        train_sac, dataclasses.replace(train_loop, rollout_steps=TRAIN_PROFILE_STEPS))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        carry, _ = prof_it(carry, env_params)
        torch.cuda.synchronize()
        train_prof_ms = (time.perf_counter() - t0) / TRAIN_PROFILE_STEPS * 1e3
    device_breakdown(prof, TRAIN_PROFILE_STEPS, train_prof_ms, "[8b]",
                     f"profiled train iteration, {N_ENVS} envs x {TRAIN_PROFILE_STEPS} steps")
    # the host side of the same run: operators by self CPU time (inflated by
    # the profiler's own cost, so read it as shares)
    host_ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    total_us = sum(e.self_cpu_time_total for e in host_ops)
    for e in host_ops[:12]:
        log(f"[8b] host {e.self_cpu_time_total / TRAIN_PROFILE_STEPS / 1e3:8.4f} ms/step "
            f"({e.self_cpu_time_total / total_us:6.2%}) {e.count / TRAIN_PROFILE_STEPS:6.1f}x "
            f"{e.key[:70]}")
    del prof, host_ops
    gc.collect()
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    batch = replay.sample(carry.buffer, train_sac.batch_size, generator=gen)
    # one update per timed window: ten would overrun the device's queue of
    # pending launches while the stream sleeps, and time the host instead
    update_ms = device_ms(lambda: sac.update(carry.agent, batch, train_sac, generator=gen),
                          reps=30, inner=1)
    update_host_ms = host_us(lambda: sac.update(carry.agent, batch, train_sac, generator=gen),
                             reps=9, inner=10) / 1e3
    rows = {k: v[:N_ENVS].clone() for k, v in carry.buffer.data.items()}

    def write_and_sample():
        return replay.sample(replay.add_batch(carry.buffer, rows), train_sac.batch_size,
                             generator=gen)

    replay_ms = device_ms(write_and_sample, reps=20, inner=20)
    replay_host_ms = host_us(write_and_sample) / 1e3
    log(f"[8b] sac.update at batch {train_sac.batch_size}: device {update_ms:.4f} ms, host "
        f"{update_host_ms:.4f} ms per call; replay add_batch ({N_ENVS} rows) + sample "
        f"({train_sac.batch_size}): device {replay_ms:.4f} ms, host {replay_host_ms:.4f} ms "
        f"per call")

    phase("[9a]")
    # ---- 9a. evaluation on the card (K1) against the CPU (plain version):
    # the same seeded actor, reset draws and IMU noise, the default training
    # env (curriculum stage 0, DR + sensor noise); then K1 below one block
    cfg = load_config(default_config_path())
    eval_params = build_env_params(cfg, cfg.curriculum.stages[0])
    eval_sac = build_sac_config(cfg)
    n_eval = cfg.training.eval_episodes
    eval_agents = {where: sac.init(n_obs, 2, eval_sac, device=where, seed=SEED)
                   for where in ("cpu", "cuda")}
    cpu_gen = torch.Generator().manual_seed(SEED + 8)
    horizon = cfg.env.max_episode_steps

    def eval_draws(steps):
        return EvalDraws(
            reset=rocket_env.draw_reset(eval_params, n_eval, torch.device("cpu"), cpu_gen),
            n_imu=torch.randn((steps, n_eval, 7), generator=cpu_gen))

    def eval_both(steps, draws):
        params = dataclasses.replace(eval_params, max_episode_steps=steps)
        fn = make_eval_fn(eval_sac, n_eval)
        out = {}
        for where in ("cpu", "cuda"):
            k1.step_kernel.launches = 0
            t0 = time.perf_counter()
            out[where] = fn(eval_agents[where], None, params, to_device(draws, where))
            summarize_stats(out[where])
            out[where + "_s"] = time.perf_counter() - t0
            out[where + "_launches"] = k1.step_kernel.launches
        ran = steps_run(out["cuda"].lengths, steps)
        assert out["cuda_launches"] == ran, (out["cuda_launches"], ran)
        assert out["cpu_launches"] == 0, out["cpu_launches"]
        return out, ran

    short_eval, ran = eval_both(64, eval_draws(64))
    a, b = short_eval["cuda"], short_eval["cpu"]
    for field in ("lengths", "success", "crashed"):
        assert torch.equal(getattr(a, field).cpu(), getattr(b, field)), f"eval {field} differs"
    torch.testing.assert_close(a.returns.cpu(), b.returns, **REWARD)
    log(f"[9a] make_eval_fn {n_eval} episodes x 64 steps, card (K1) vs CPU (plain): lengths, "
        f"success, crash equal; max |d return| {float((a.returns.cpu() - b.returns).abs().max()):.3e} "
        f"(atol {REWARD['atol']}, rtol {REWARD['rtol']}); {int((b.lengths == 64).sum())} of "
        f"{n_eval} episodes reach the horizon; {ran} steps run, K1 launches "
        f"{short_eval['cuda_launches']}: ok")
    # the eval step's own cost: a rollout held to its horizon (no early
    # exit), timed over EVAL_TIMED_STEPS and profiled over PROFILE_STEPS
    for steps, profiled in ((EVAL_TIMED_STEPS, False), (PROFILE_STEPS, True)):
        params_t = dataclasses.replace(eval_params, max_episode_steps=steps)
        fn = make_eval_fn(eval_sac, n_eval, check_every=10**9)
        fn(eval_agents["cuda"], gen, params_t)   # warm-up
        torch.cuda.synchronize()
        tracer = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                  if profiled else contextlib.nullcontext())
        with tracer as prof:
            t0 = time.perf_counter()
            summarize_stats(fn(eval_agents["cuda"], gen, params_t))
            step_ms = (time.perf_counter() - t0) / steps * 1e3
        if profiled:
            device_breakdown(prof, steps, step_ms, "[9a]",
                             f"profiled eval step, {n_eval} episodes x {steps} steps")
        else:
            eval_step_ms = step_ms
            log(f"[9a] eval step at N = {n_eval}, {steps} steps held to the horizon: "
                f"{step_ms:.4f} ms per step = {1e3 / step_ms:.1f} eval steps/s")
        del prof
    gc.collect()
    full_eval, full_ran = eval_both(horizon, eval_draws(horizon))
    a, b = full_eval["cuda"], full_eval["cpu"]
    differ = int(((a.lengths.cpu() != b.lengths) | (a.success.cpu() != b.success)
                  | (a.crashed.cpu() != b.crashed)).sum())
    eval_rate = full_ran / full_eval["cuda_s"]
    log(f"[9a] full horizon ({horizon} steps): {differ} of {n_eval} episodes' outcomes differ "
        f"card vs CPU (not held: float32 rounding may flip a termination near its threshold); "
        f"card: {full_ran} steps run before the early exit in {full_eval['cuda_s']:.3f} s = "
        f"{eval_rate:.1f} eval steps/s at N = {n_eval} ({full_eval['cuda_s'] / full_ran * 1e3:.3f} "
        f"ms per step), K1 launches {full_eval['cuda_launches']}; CPU "
        f"{full_eval['cpu_s']:.3f} s; max length {int(b.lengths.max())}, success "
        f"{float(a.success.float().mean()):.2f}, crash {float(a.crashed.float().mean()):.2f}")
    small_n = k1_below_one_block(gen, dev, params, errs)
    del eval_agents, short_eval, full_eval

    phase("[9]")
    # ---- 9. the trainer at the default configuration, 2 iterations with an
    # eval round after each, then resumed from its final checkpoint into a
    # 3rd, and once from a best step directory
    scratch = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    try:
        trainer_launches = run_trainer(scratch, dev)
        phase("[9b]")
        eval_launches = run_suites(scratch, dev, n_obs)

        # ---- 10. the ensemble: card vs CPU per acting member, the trainer
        # at the default config, the flagship configuration
        phase("[10]")
        errs.append(ensemble_card_vs_cpu(short))
        phase("[10b]")
        ensemble_launches = run_ensemble_trainer(scratch, dev)
        phase("[10c]")
        ensemble_launches["flagship"] = run_flagship(scratch, dev)

        # ---- 11. the robust-training env options: card vs CPU with every
        # option on, robust_full_r4d.yaml at its widths, its resume
        phase("[11a]")
        robust_card_vs_cpu(dev)
        ensemble_launches["robust_card_vs_cpu"] = ROBUST_STEPS
        phase("[11b]")
        ensemble_launches["robust_r4d"] = run_robust_trainer(scratch, dev)

        # ---- 12. the SAC learner's extensions: the transformer policy card
        # vs CPU and transformer_r3.yaml at its widths; ICM, the
        # physics-informed loss, RND and hierarchical RL card vs CPU and at
        # the default config
        phase("[12a]")
        transformer_card_vs_cpu(dev)
        phase("[12b]")
        ensemble_launches["transformer_r3"] = run_transformer_trainer(scratch, dev)
        phase("[12c]")
        extensions_card_vs_cpu(dev)
        ensemble_launches["extensions_card_vs_cpu"] = EXT_STEPS
        phase("[12c] trainer")
        ensemble_launches["extensions"] = run_extension_trainer(scratch, dev)

        # ---- 13. the export of [9]'s trained actor through the native int8
        # runtime; population training; the safety correction net
        phase("[13a]")
        ensemble_launches["export_calibration"] = export_trained_actor(
            scratch, dev, n_obs, native_before)
        phase("[13b]")
        population_card_vs_cpu(dev, short)
        ensemble_launches["population_card_vs_cpu"] = (POP_CHECK["num_agents"]
                                                       * POP_CHECK["rollout_steps"])
        phase("[13b] defaults")
        ensemble_launches["population"] = run_population(dev, env_params)
        phase("[13c]")
        safety_card_vs_cpu(dev, n_obs)

        # ---- 14. data parallel: card vs CPU at world 2 on gloo; the default
        # configuration unsharded, at world 1 on NCCL and at world 2 on gloo
        phase("[14a]")
        ensemble_launches.update(
            {f"dp_{k}": v for k, v in dp_card_vs_cpu(scratch).items()})
        phase("[14b]")
        ensemble_launches.update(
            {f"dp_full_{k.replace(' ', '_')}": v for k, v in dp_full_width(scratch, dev).items()})
        phase("[14c]")
        ensemble_launches.update(dp_nccl_world2(scratch))

        # ---- 15. LQR demonstration seeding: card vs CPU; robust_r4.yaml
        phase("[15a]")
        demos_card_vs_cpu(dev)
        ensemble_launches["demos_card_vs_cpu"] = DEMO_STEPS
        phase("[15b]")
        ensemble_launches.update(run_robust_r4(scratch, dev))

        # ---- 16. the distillation chain: the gain schedule, CEM, DAgger,
        # the θ-student, the warm-started fine-tune and the pilot
        phase("[16a]")
        sched, ensemble_launches["schedule_verification"] = schedule_card_vs_cpu(dev)
        phase("[16b]")
        ensemble_launches.update(cem_card_vs_cpu(dev, sched))
        phase("[16c]")
        dagger_launches, student_path, student = run_dagger(scratch, dev, sched)
        ensemble_launches.update(dagger_launches)
        phase("[16d]")
        ensemble_launches.update(run_theta(dev, sched))
        phase("[16e]")
        ensemble_launches["student_ft"] = run_student_finetune(scratch, dev, student_path,
                                                               student)
        ensemble_launches["pilot_card_vs_cpu"] = pilot_card_vs_cpu(dev, sched)
        phase("[16e] pilot_eval")
        ensemble_launches["pilot_eval"] = run_pilot_eval(dev)

        # ---- 17. the single-env surface: the gym envs card vs CPU (K1 at
        # N = 1), the legacy mini training, the six research diagnostics
        phase("[17a]")
        ensemble_launches.update(
            {f"single_{k}": v for k, v in single_env_card_vs_cpu(dev).items()})
        phase("[17b]")
        ensemble_launches["legacy_mini_training"] = legacy_mini_training(dev)
        phase("[17c]")
        ensemble_launches.update(
            {f"cli_{k}": v for k, v in run_single_env_clis(scratch, student_path).items()})

        # ---- 18. the last modules: the PyBullet-parity trajectory through K1
        # at N = 1 and its check command, the HPO command at its width, the
        # reference's remaining names card vs CPU, [9]'s training plots
        phase("[18a]")
        ensemble_launches.update(parity_card_vs_cpu(scratch, dev))
        phase("[18b]")
        ensemble_launches["hpo"] = run_hpo(scratch)
        phase("[18c]")
        ensemble_launches["act_fn_iteration"] = remnants_card_vs_cpu(dev, short)
        phase("[18d]")
        plots_of_trainer_run(scratch)

        # ---- 19. the last two options: bfloat16 compute card vs CPU and
        # against float32 at full width; the hoisted chunk path card vs CPU,
        # against the per-step cadence, and at full width
        phase("[19a]")
        ensemble_launches["bf16_card_vs_cpu"] = bf16_card_vs_cpu(dev, short)
        ensemble_launches.update(bf16_full_width(dev, env_params))
        phase("[19b]")
        ensemble_launches.update(hoisted_card_vs_cpu(dev, short))
        ensemble_launches.update(hoisted_full_width(dev, env_params))

        # ---- 20. the JAX package's msgpack artifacts on the card: each
        # fixture held against the JAX package's outputs, the suites on its
        # default-width policy, a trainer warm-started from its student
        phase("[20]")
        ensemble_launches.update(jax_artifacts_on_card(scratch, dev))

        # ---- 21. the JAX trainer's orbax checkpoint on the card: decoded by
        # the port's own reader, each leaf and the agent's outputs held, the
        # suites on its agent and a trainer resumed from it
        phase("[21]")
        ensemble_launches.update(jax_orbax_on_card(scratch, dev))

        # ---- 22. the JAX trainer's checkpoint written by two devices: its
        # shards resumed at world 2 (two gloo ranks on the card) and re-laid
        # at world 1, each then trained one iteration with its eval round
        phase("[22]")
        ensemble_launches.update(jax_orbax_mesh_on_card(scratch, dev))
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    log(f"[t] seconds by phase: {phase_seconds()}")

    log(smi)
    log(json.dumps({"kernels": [{
        "name": "K1 step_kernel",
        "route": "cuda",
        "source": "tvc_ai_torch/csrc/step_kernel.cu",
        "replaces": "tvc_ai_tpu/ops/pallas_step.py:73",
        "launches": trainer_launches,
        "launches_by_path": {"env": env_launches, "rollout": main_launches,
                             "train": train_launches, "eval": eval_launches,
                             "trainer": trainer_launches, **ensemble_launches},
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "floor_ms": floor_ms,
        "host_us": call_us,
        "eval_step_ms": eval_step_ms,
        "ms_by_n": {str(n): v[0] for n, v in small_n.items()},
        "floor_ms_by_n": {str(n): v[1] for n, v in small_n.items()},
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
