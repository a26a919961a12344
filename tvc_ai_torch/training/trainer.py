"""The training orchestrator — config in, trained policy out.

Counterpart of ``tvc_ai_tpu/training/trainer.py::Trainer``, on one device or
data parallel over several processes (``parallel.mesh``):

- the hot loop is ``training.loop.make_train_iteration`` (K1 for the physics
  on the card), one call per iteration;
- curriculum promotion rebuilds the env parameters, driven by the
  iteration's episode stats and by the stage's own evaluation;
- the reward-hacking detector reads the finished episodes drained from the
  carry's ring every iteration;
- the stability manager's interventions (primacy reset, dormant-unit
  reinit) change the actor in place between iterations;
- evaluation is the batched deterministic rollout of ``eval.rollout`` on the
  EMA actor when there is one (nominal, optional robust, and stage evals);
  in hierarchical mode ``make_hier_eval_fn`` on ``(actor, high level)``;
- checkpoints are ``utils.checkpoint`` (best, best-nominal, periodic, final,
  and a recovery save on an exception) with a real ``resume``, which also
  takes the JAX package's orbax checkpoints (``utils.orbax_read``, then
  ``convert.train_carry_from_numpy``; at world 1 only).

One ``torch.Generator`` on the device, seeded from ``globals.seed``, stands
in for the reference's ``self.key``: it seeds the carry and draws the
evaluations and the interventions; the carry keeps its own generator for the
iteration. Both generators' states are checkpointed, so a resumed run
continues exactly. A JAX checkpoint holds JAX keys instead, which are
dropped: resuming one seeds both generators from ``globals.seed``.

The host reads the device once per iteration (the metrics, ``summarize``,
the episode ring), never per step. Each ``train_iteration`` stage ends in a
device synchronisation so that ``StageTimer`` times the iteration, not its
enqueue.

The dormant-unit check probes the actor with what it sees: in hierarchical
mode the goal-augmented observation (the reference probes with the bare
observation, which does not fit an MLP actor's first layer there).

``training.demo_seeding`` seeds the replay (and, with ``fraction > 0``, a
persistent demo buffer) with LQR demonstrations (``training.demos``) on a
fresh start; a resume restores both buffers.

Data parallel. ``hardware.mesh_devices`` decides, by the reference's rule:
0 runs at the world that was launched (``torchrun``; one process is world 1,
with no group), 1 asks for a single process, N > 1 for exactly N. At a world
above 1 each rank runs ``mesh.make_sharded_train``'s iteration on its shard
(NCCL on CUDA, gloo on the CPU), and everything that decides replicated
state or control flow is the same on every rank, or a rank would take
another branch and hang in the next collective:

- the counters are summed over the ranks (``loop.counter_totals``) and the
  episode rings gathered (``loop.drain_episodes``), so the curriculum, the
  hacking detector and the checkpoint cadence see the global run;
- rank 0 evaluates, then broadcasts the eval metrics with the trainer
  generator's state (``broadcast_object_list``); every rank applies the
  same outcome (best and early-stopping logic, eval-driven promotion);
- the trainer generator is seeded alike on every rank, so the primacy reset
  draws alike; the dormant check probes with rank 0's observations;
- rank 0 logs; every rank writes its shard of each checkpoint
  (``utils.checkpoint``), and a resume needs the same world size.

``training.demo_seeding`` and ``training.warm_start_actor`` are
single-device, as in the reference (``ValueError`` at a world above 1).
``training.warm_start_actor`` reads the port's own student artifact (a
``SACAgent.save``-form file, which ``python -m tvc_ai_torch.dagger_distill``
writes) and the JAX package's flax msgpack student (``student.msgpack``).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from pathlib import Path

import torch

from tvc_ai_torch import convert
from tvc_ai_torch.agents import replay as replay_mod
from tvc_ai_torch.agents import sac as sac_mod
from tvc_ai_torch.agents.legacy import read_agent_file
from tvc_ai_torch.config.build import build_env_params, build_loop_config, build_sac_config
from tvc_ai_torch.config.schema import FrameworkConfig
from tvc_ai_torch.eval.rollout import make_eval_fn, make_hier_eval_fn, summarize_stats
from tvc_ai_torch.parallel import mesh
from tvc_ai_torch.training import demos
from tvc_ai_torch.training import loop as loop_mod
from tvc_ai_torch.training.curriculum import CurriculumManager
from tvc_ai_torch.training.hacking import RewardHackingDetector
from tvc_ai_torch.training.stability import (
    StabilityConfig,
    TrainingStabilityManager,
    reinit_dormant_units,
)
from tvc_ai_torch.utils.checkpoint import CheckpointManager, load_state, save_json
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device
from tvc_ai_torch.utils.logging import SilentLogger, TrainingLogger, make_output_dir
from tvc_ai_torch.utils.orbax_read import OrbaxCheckpoints
from tvc_ai_torch.utils.profiling import StageTimer


def check_supported(cfg: FrameworkConfig, world: int) -> None:
    """Refuse the options this trainer does not run at ``world`` processes:
    the reference's ``ValueError``s, and ``NotImplementedError`` for what is
    not ported."""
    if cfg.training.warm_start_actor and world > 1:
        raise ValueError("training.warm_start_actor is single-device for now")
    if cfg.training.demo_seeding.enabled and cfg.hierarchical_rl.enabled:
        raise ValueError(
            "training.demo_seeding does not support hierarchical mode "
            "(demos would need goal-augmented views)"
        )
    if cfg.training.demo_seeding.enabled and world > 1:
        raise ValueError(
            "training.demo_seeding is single-device for now (the sharded replay buffer "
            "would need per-shard ring writes)"
        )


def demo_env_params(cfg: FrameworkConfig):
    """The env the demonstrations run in: the training env with the
    ``training.demo_seeding`` overrides (those set) applied to its domain
    randomization and initial conditions."""
    ds = cfg.training.demo_seeding
    demo_cfg = copy.deepcopy(cfg)
    dr = demo_cfg.env.domain_randomization
    for name in ("cg_offset_max", "mass_variation", "thrust_variation", "wind_max",
                 "sensor_noise_std", "dr_prob", "init_tilt_max", "init_omega_max"):
        v = getattr(ds, name)
        if v is not None:
            setattr(dr, name, v)
    return build_env_params(demo_cfg)


def agreed_output_dir(output_dir: str | Path | None, base: str, experiment: str) -> Path:
    """``output_dir``, or a fresh timestamped run directory that rank 0 makes
    and every rank of a data-parallel group then shares."""
    if output_dir:
        return Path(output_dir)
    made = str(make_output_dir(base, experiment)) if mesh.rank() == 0 else None
    return Path(mesh.broadcast_object(made))


class Trainer:
    def __init__(
        self,
        cfg: FrameworkConfig,
        output_dir: str | Path | None = None,
        resume: str | Path | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.world = mesh.resolve_world(cfg.hardware.mesh_devices)
        check_supported(cfg, self.world)
        self.device = (mesh.init_data_parallel(device) if self.world > 1
                       else resolve_device(device))
        self.rank = mesh.rank()
        self.axis = mesh.DATA_AXIS if self.world > 1 else None
        self.cfg = cfg
        self.output_dir = agreed_output_dir(output_dir, cfg.globals.output_dir,
                                            cfg.globals.experiment_name)
        self.logger = TrainingLogger(
            self.output_dir,
            level=cfg.logging.level,
            tensorboard=cfg.logging.tensorboard,
            csv_enabled=cfg.logging.csv,
            wandb_enabled=cfg.logging.wandb_enabled,
            wandb_mode=cfg.logging.wandb_mode,
            wandb_config=cfg.to_dict(),
        ) if self.rank == 0 else SilentLogger(self.output_dir)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.globals.seed)

        # ---- subsystems
        self.curriculum = CurriculumManager(cfg)
        self.hacking = RewardHackingDetector()
        st = cfg.stability
        self.stability = TrainingStabilityManager(
            StabilityConfig(
                enable_lr_scheduling=st.enable_lr_scheduling,
                scheduler_type=st.scheduler_type,
                enable_plasticity_preservation=st.enable_plasticity_preservation,
                dormant_check_interval=st.dormant_check_interval,
                enable_primacy_mitigation=st.enable_primacy_mitigation,
                reset_interval=st.reset_interval,
                reset_ratio=st.reset_ratio,
                adaptive_tau=st.adaptive_tau,
                hacking_stop_threshold=st.hacking_stop_threshold,
            ),
            cfg.training.total_timesteps,
        )

        # ---- configs; the schedule horizon is the trainer's (it leaves
        # update_interval out, unlike build_sac_config's)
        self.sac_cfg = dataclasses.replace(
            build_sac_config(cfg),
            schedule_total_steps=max(
                cfg.training.total_timesteps
                // max(cfg.training.num_envs, 1)
                * cfg.training.updates_per_step,
                1,
            ),
        )
        self.loop_cfg = build_loop_config(cfg)
        self.env_params = build_env_params(cfg, self.curriculum.get_environment_config())
        # eval: nominal task, no randomization (sensor noise per
        # training.eval_sensor_noise)
        eval_cfg = copy.deepcopy(cfg)
        eval_cfg.env.domain_randomization.enabled = False
        eval_cfg.env.domain_randomization.sensor_noise_enabled = (
            cfg.training.eval_sensor_noise
        )
        self.eval_env_params = build_env_params(eval_cfg)
        # optional second eval under full domain randomization at dr_prob 1,
        # reported as eval_robust_*
        self.robust_eval_env_params = None
        if cfg.training.early_stopping.metric.startswith(
            "eval_robust_"
        ) and not cfg.training.eval_domain_randomization:
            # without the robust eval, evaluate() never produces eval_robust_*
            # and best capture / early stopping would silently fall back to
            # the nominal metric
            raise ValueError(
                f"early_stopping.metric="
                f"{cfg.training.early_stopping.metric!r} requires "
                "training.eval_domain_randomization=true (the robust eval is "
                "what produces eval_robust_* metrics)"
            )
        if cfg.training.eval_domain_randomization:
            robust_cfg = copy.deepcopy(cfg)
            robust_cfg.env.domain_randomization.enabled = True
            robust_cfg.env.domain_randomization.dr_prob = 1.0
            robust_cfg.env.domain_randomization.sensor_noise_enabled = (
                cfg.training.eval_sensor_noise
            )
            robust_cfg.env.domain_randomization.feasible_only = False
            self.robust_eval_env_params = build_env_params(robust_cfg)
        # third eval: the current curriculum stage's conditions at dr_prob 1,
        # the promotion gate
        self.stage_eval_env_params = self._build_stage_eval_params()

        # ---- the iteration and the evaluation
        if self.world > 1:
            init_fn, self._train_fn = mesh.make_sharded_train(
                self.env_params, self.sac_cfg, self.loop_cfg, self.device)
        else:
            def init_fn(seed):
                return loop_mod.init_carry(self.env_params, self.sac_cfg, self.loop_cfg,
                                           self.device, seed=seed)
            self._train_fn = loop_mod.make_train_iteration(self.sac_cfg, self.loop_cfg)
        if self.loop_cfg.use_hierarchical:
            self._eval_fn = make_hier_eval_fn(
                self.sac_cfg, self.loop_cfg.hierarchical, cfg.training.eval_episodes,
                history_len=self.loop_cfg.history_len,
            )
        else:
            self._eval_fn = make_eval_fn(
                self.sac_cfg, cfg.training.eval_episodes, history_len=self.loop_cfg.history_len
            )
        if self.world > 1:
            self.logger.info("data parallel: %d ranks (%s), %d envs each", self.world,
                             torch.distributed.get_backend(),
                             self.loop_cfg.num_envs // self.world)
        else:
            self.logger.info("single device: %s", self.device)

        # ---- state
        self.timer = StageTimer()
        self.carry = init_fn(self._next_seed())
        if cfg.training.warm_start_actor:
            self._warm_start_actor(cfg.training.warm_start_actor)
        self.stability.register_initial_params(self.carry.agent.actor)
        if cfg.training.demo_seeding.enabled:
            # a resume restores both buffers into the structure made here
            self._seed_demonstrations(generate=resume is None)
        self.ckpt = CheckpointManager(self.output_dir / "checkpoints")
        # best checkpoints live in their own managers so that pruning of the
        # periodic saves never evicts them
        self.ckpt_best = CheckpointManager(self.output_dir / "checkpoints_best", max_to_keep=2)
        self.ckpt_best_nominal = CheckpointManager(
            self.output_dir / "checkpoints_best_nominal", max_to_keep=2
        )
        self.best_metric = float("-inf")
        self.best_nominal_key = (float("-inf"), float("-inf"))
        self.best_significant_metric = float("-inf")
        self.eval_rounds_since_improvement = 0
        self.iteration = 0
        self._last_episodes = 0
        self._last_successes = 0
        self._last_ep_seq = -1
        if resume is not None:
            self._resume(resume)

    # ------------------------------------------------------------------ util
    def _next_seed(self) -> int:
        """A seed drawn from the trainer's generator (the reference splits its key)."""
        return int(torch.randint(2**62, (), generator=self.generator, device=self.device))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warm_start_actor(self, path: str | Path) -> None:
        """Replace the fresh actor (and its EMA shadow) with a distilled
        student's: the actor of a ``SACAgent.save``-form file (the
        ``student.pt`` that ``python -m tvc_ai_torch.dagger_distill``
        writes) or of the JAX package's flax msgpack student
        (``{"state": SACState}``, ``scripts/dagger_distill.py``), both through
        ``agents.legacy.read_agent_file``. The critic, the targets and the
        optimizers stay fresh, as in the reference: the critic must learn the
        student's values from data, and a stale Adam state would move the
        distilled weights at once."""
        if self.world > 1:
            raise ValueError("training.warm_start_actor is single-device for now")
        state = read_agent_file(path, self.device)["state"]
        student = state["actor"]["__module_state__"]
        actor = self.carry.agent.actor

        def shapes(sd):
            return {k: tuple(v.shape) for k, v in sd.items()}

        if shapes(student) != shapes(actor.state_dict()):
            raise ValueError(
                f"warm_start_actor {str(path)!r}: actor shape mismatch — the "
                f"student was trained with a different view "
                f"(obs_dim × history) or hidden_dims than this config. "
                f"student={shapes(student)} vs trainer={shapes(actor.state_dict())}")
        actor.load_state_dict(student)
        ema = self.carry.agent.ema_actor
        if ema is not None:
            ema.load_state_dict(student)
        self.logger.info("actor warm-started from %s", path)

    def _seed_demonstrations(self, generate: bool = True) -> None:
        """Seed the replay with LQR ground-balance demonstrations
        (``training.demo_seeding``) before the first iteration, so the critic
        sees the CG-trim skill's value landscape, the sparse completion bonus
        included, from its first step; with ``fraction > 0`` also build the
        persistent demo buffer the loop mixes into every batch. With
        ``generate`` False (a resume) only the demo buffer's structure is
        made, for the checkpoint to fill."""
        ds = self.cfg.training.demo_seeding
        n = ds.envs or self.loop_cfg.num_envs
        if self.loop_cfg.num_envs % n != 0:
            raise ValueError(
                f"demo_seeding.envs ({n}) must divide training.num_envs "
                f"({self.loop_cfg.num_envs}) so the replay ring's batch-write invariant holds"
            )
        total = ds.steps * n
        if not generate:
            if ds.fraction > 0:
                self.carry.demo_buffer = replay_mod.ReplayBuffer.create(
                    total, loop_mod.example_transition(self.loop_cfg), self.device)
            return
        demo_params = demo_env_params(self.cfg)
        t0 = time.perf_counter()
        design = demos.design_lqr(demo_params)
        design_s = time.perf_counter() - t0
        gen = torch.Generator(device=self.device).manual_seed(self._next_seed())
        transitions, stats = demos.generate_demonstrations(
            demo_params, design, n, ds.steps, privileged=ds.privileged,
            history_len=self.loop_cfg.history_len, device=self.device, generator=gen)
        if total > self.carry.buffer.capacity:
            self.logger.info(
                "demo seeding exceeds replay capacity (%d > %d): the ring keeps only the "
                "most recent demos", total, self.carry.buffer.capacity)
        self.carry.buffer = demos.seed_replay_buffer(self.carry.buffer, transitions)
        if ds.fraction > 0:
            # exactly sized, fully filled, never written again
            example = {k: v[0, 0] for k, v in transitions.items()}
            self.carry.demo_buffer = demos.seed_replay_buffer(
                replay_mod.ReplayBuffer.create(total, example, self.device), transitions)
        self.demo_seconds = time.perf_counter() - t0
        self.logger.info(
            "demo seeding: %d LQR transitions (%d episodes, %.1f%% success, cg_max %.3f) in "
            "%.2f s (LQR design %.2f s)",
            int(stats["demo_transitions"]), int(stats["demo_episodes"]),
            100 * stats["demo_success_rate"], demo_params.randomization.cg_offset_max,
            self.demo_seconds, design_s)
        self.demo_stats = stats
        self.logger.log_metrics(0, {f"demo/{k}": v for k, v in stats.items()})

    def _payload(self) -> dict:
        """What a checkpoint holds besides the host state."""
        return {"carry": self.carry, "generator": self.generator}

    def _save(self, mngr: CheckpointManager, step: int) -> None:
        with self.timer.stage("checkpoint"):
            if self.world > 1:
                mngr.save(step, self._payload(), self._host_state(), self.rank, self.world)
            else:
                mngr.save(step, self._payload(), self._host_state())

    def _host_state(self) -> dict:
        return {
            "iteration": self.iteration,
            "best_metric": self.best_metric,
            "best_nominal_key": list(self.best_nominal_key),
            "best_significant_metric": self.best_significant_metric,
            "curriculum": self.curriculum.state_dict(),
            "stability": self.stability.state_dict(),
            "last_episodes": self._last_episodes,
            "last_successes": self._last_successes,
            "last_ep_seq": self._last_ep_seq,
        }

    def _resume(self, resume_dir) -> None:
        """Resume from a manager root (its latest step) or one step directory
        (exactly that step), of the port or of the JAX package's orbax.
        Field-tolerant: a field the checkpoint lacks keeps the fresh carry's
        value. Tensor shapes follow the checkpoint (its env batch and replay
        capacity), not the new config."""
        mngr, step = CheckpointManager.locate(resume_dir)
        if isinstance(mngr, OrbaxCheckpoints):
            if self.world > 1:
                raise ValueError(
                    f"{mngr.directory / str(step)} is an orbax checkpoint of the JAX package; "
                    f"resuming one runs at world 1, not {self.world}")
            self.carry = self._carry_from_orbax(mngr.read(step))
            self.generator.manual_seed(self.cfg.globals.seed)
            host = mngr.host(step)
        else:
            state, host = mngr.restore(step, self.device, self.rank, self.world)
            self.carry = load_state(self.carry, state["carry"])
            if "generator" in state:
                load_state(self.generator, state["generator"])
        self.iteration = int(host.get("iteration", 0))
        self.best_metric = float(host.get("best_metric", float("-inf")))
        if self.ckpt_best.latest_step() is None:
            # resuming into a fresh run: a best metric from another eval
            # regime would suppress every best save, so start anew
            self.best_metric = float("-inf")
        key = host.get("best_nominal_key")
        if key is None:   # the reference's checkpoints before best_nominal_key
            key = [host.get("best_nominal_metric", float("-inf")), float("-inf")]
        self.best_nominal_key = (float(key[0]), float(key[1]))
        if self.ckpt_best_nominal.latest_step() is None:
            self.best_nominal_key = (float("-inf"), float("-inf"))
        self.best_significant_metric = float(
            host.get("best_significant_metric", self.best_metric)
        )
        self.curriculum.load_state_dict(host.get("curriculum", {}))
        # the restored stage may differ from the constructor's stage 0
        self.env_params = build_env_params(
            self.cfg, self.curriculum.get_environment_config()
        )
        self.stage_eval_env_params = self._build_stage_eval_params()
        self.stability.load_state_dict(host.get("stability", {}))
        self._last_episodes = int(host.get("last_episodes", 0))
        self._last_successes = int(host.get("last_successes", 0))
        self._last_ep_seq = int(host.get("last_ep_seq", -1))
        self.logger.info(
            "resumed from %s step %d at iteration %d (%s env steps)",
            mngr.directory,
            step,
            self.iteration,
            f"{self.env_steps:,}",
        )

    def _carry_from_orbax(self, disk: dict) -> loop_mod.TrainCarry:
        """The carry of a JAX ``TrainCarry`` read from orbax, through
        ``convert.train_carry_from_numpy``, as the reference's ``fill`` merges
        it: a field the checkpoint lacks or holds as None (and an
        ``env_states.prev_imu`` it lacks) keeps the fresh carry's value; a
        field the config turns off stays off. The carry's generator is seeded
        from ``globals.seed``."""
        fresh = self.carry
        names = [f.name for f in dataclasses.fields(fresh)
                 if f.name not in ("generator", "env_steps_host")]
        taken = {n for n in names
                 if disk.get(n) is not None and getattr(fresh, n) is not None}
        missing = {"env_states", "agent", "buffer"} - taken
        if missing:
            raise ValueError(f"the orbax carry lacks {sorted(missing)}")
        full = {n: disk[n] if n in taken else None for n in names}
        for n in names:
            value = getattr(fresh, n)
            if n not in taken and isinstance(value, torch.Tensor):
                full[n] = value.cpu().numpy()
        carry = convert.train_carry_from_numpy(full, self.sac_cfg, self.loop_cfg, self.device,
                                               seed=self.cfg.globals.seed)
        kept = {n: getattr(fresh, n) for n in names if n not in taken}
        if carry.env_states.prev_imu is None and fresh.env_states.prev_imu is not None:
            kept["env_states"] = dataclasses.replace(carry.env_states,
                                                     prev_imu=fresh.env_states.prev_imu)
        return dataclasses.replace(carry, **kept)

    @property
    def env_steps(self) -> int:
        """Env steps taken by the whole run (every rank's envs)."""
        if self.world > 1:   # every env slot has taken env_steps_host steps
            return self.carry.env_steps_host * self.carry.obs.shape[0] * self.world
        return int(self.carry.env_steps.sum())

    # ------------------------------------------------------------------ train
    def train(self) -> dict:
        cfg = self.cfg.training
        steps_per_iter = self.loop_cfg.num_envs * self.loop_cfg.rollout_steps
        eval_every = max(cfg.eval_freq // steps_per_iter, 1)
        # periodic-save cadence: training.save_freq, unless
        # checkpointing.period is set to something other than its default
        period = cfg.checkpointing.period
        save_steps = period if period != 25_000 else cfg.save_freq
        save_every = max(save_steps // steps_per_iter, 1)
        self.logger.info(
            "training: %s total steps, %d envs x %d rollout steps/iter",
            f"{cfg.total_timesteps:,}",
            self.loop_cfg.num_envs,
            self.loop_cfg.rollout_steps,
        )
        t_start = time.perf_counter()
        try:
            stop_reason = self._train_loop(cfg, eval_every, save_every)
        except KeyboardInterrupt:
            stop_reason = "interrupted"
            self.logger.warning("interrupted — saving recovery checkpoint")
            self._save(self.ckpt, self.env_steps)
        except Exception:
            if self.world > 1:
                # the other ranks may never reach the save's barriers
                self.logger.warning("error — a data-parallel run saves no recovery checkpoint")
                raise
            self.logger.warning("error — saving recovery checkpoint")
            self._save(self.ckpt, self.env_steps)
            raise

        # ---- final artifacts
        elapsed = time.perf_counter() - t_start
        final_eval = self.evaluate_on_rank0()
        if cfg.checkpointing.save_last:
            self._save(self.ckpt, self.env_steps)
        result = {
            "env_steps": self.env_steps,
            "iterations": self.iteration,
            "wallclock_sec": elapsed,
            "steps_per_sec": self.env_steps / max(elapsed, 1e-9),
            "stop_reason": stop_reason,
            "best_metric": self.best_metric,
            "curriculum_stage": self.curriculum.stage_idx,
            "curriculum_stalled": self.curriculum.watchdog_alert() is not None,
            "curriculum_forced_promotions": sum(
                1 for h in self.curriculum.history if h.get("forced")
            ),
            "hacking_score": self.hacking.detect_hacking().score,
            "stage_timing": self.timer.report(),
            **final_eval,
        }
        if self.rank == 0:
            save_json(self.output_dir / "final_metrics.json", result)
            self.curriculum.save_curriculum_data(self.output_dir / "curriculum.json")
        self.logger.info("stage timing: %s", self.timer.summary_line())
        self.logger.info(
            "done: %s env steps in %.1fs (%s steps/s), final success %.2f%%",
            f"{self.env_steps:,}",
            elapsed,
            f"{result['steps_per_sec']:,.0f}",
            100 * result["eval_success_rate"],
        )
        self.logger.close()
        return result

    def _train_loop(self, cfg, eval_every: int, save_every: int) -> str:
        steps_per_iter = self.loop_cfg.num_envs * self.loop_cfg.rollout_steps
        while self.env_steps < cfg.total_timesteps:
            with self.timer.stage("train_iteration"):
                self.carry, metrics = self._train_fn(self.carry, self.env_params)
                self._sync()
            self.iteration += 1
            self.stability.step(
                self.loop_cfg.rollout_steps * self.loop_cfg.updates_per_step
            )

            # ---- the host's one read of the device this iteration (the
            # counters summed over the ranks under data parallelism)
            metrics = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
            totals = loop_mod.counter_totals(self.carry, self.axis)
            summary = loop_mod.summarize(self.carry, totals=totals)
            successes = int(totals["successes"])
            metrics.update(summary)
            # per-episode success over this iteration's finished episodes
            # (summary["success_rate"] is the lifetime mean)
            ep_delta = summary["episodes"] - self._last_episodes
            succ_delta = successes - self._last_successes
            self._last_episodes = summary["episodes"]
            self._last_successes = successes
            rate = succ_delta / ep_delta if ep_delta > 0 else 0.0
            metrics["success_rate_recent"] = rate
            env_steps = summary["env_steps"]
            self.logger.log_metrics(env_steps, metrics)
            if self.iteration % self.cfg.logging.log_freq_iterations == 0:
                self.logger.progress_line(
                    env_steps,
                    cfg.total_timesteps,
                    {
                        k: metrics[k]
                        for k in ("reward_mean", "success_rate_recent", "critic_loss",
                                  "actor_loss", "alpha")
                        if k in metrics
                    },
                )
            if self.curriculum.update(ep_delta, rate, steps_per_iter):
                stage = self.curriculum.get_environment_config()
                self.env_params = build_env_params(self.cfg, stage)
                self.stage_eval_env_params = self._build_stage_eval_params()
                self.logger.info(
                    "curriculum advanced to stage %d (%s)",
                    self.curriculum.stage_idx,
                    stage.name if stage else "graduated",
                )
            # the finished episodes, in completion order, feed the detector
            episodes, self._last_ep_seq = loop_mod.drain_episodes(
                self.carry, self._last_ep_seq, self.axis
            )
            for ret, length, success in episodes:
                self.hacking.add_episode(reward=ret, success=success, length=length)

            report = self.hacking.detect_hacking()
            if report.is_hacking:
                self.logger.warning(
                    "reward hacking suspected (score %.2f): %s",
                    report.score,
                    report.indicators,
                )
            if self.stability.should_stop_training(report.score):
                self.logger.warning("stopping: hacking score %.2f", report.score)
                return "reward_hacking"

            # ---- stability interventions, on the live actor in place
            if self.stability.due_primacy_reset():
                self.stability.apply_primacy_reset(self.carry.agent.actor, self.generator)
                self.logger.info("primacy-bias mitigation: partial weight reset")
            if self.stability.due_dormant_check():
                probe = self.carry.obs[:256]
                if self.loop_cfg.use_hierarchical:
                    probe = loop_mod.augment_with_goal(probe, self.carry.goal[:256], self.loop_cfg)
                # every rank reinitializes from rank 0's probe
                probe = mesh.broadcast_(probe.clone()) if self.world > 1 else probe
                reinit_dormant_units(
                    self.carry.agent.actor,
                    probe,
                    self.stability.cfg.dormant_threshold,
                    self.stability.cfg.reinit_dormant_ratio,
                    generator=self.generator,
                )

            # ---- eval / early stopping / checkpoints
            if self.iteration % eval_every == 0:
                with self.timer.stage("evaluate"):
                    eval_metrics = self.evaluate_on_rank0()
                self.logger.log_metrics(env_steps, eval_metrics)
                outcome = self._apply_eval_outcome(eval_metrics)
                if outcome is not None:
                    return outcome
            elif cfg.checkpointing.save_periodic and self.iteration % save_every == 0:
                self._save(self.ckpt, env_steps)
        return "total_timesteps"

    def _apply_eval_outcome(self, eval_metrics: dict) -> str | None:
        """Host-side gating on one eval round: stage-gated curriculum
        promotion, lexicographic best-nominal capture, primary best capture,
        early-stopping patience. Returns a stop reason or None."""
        cfg = self.cfg.training
        robust_part = (
            " robust %.2f%%" % (100 * eval_metrics["eval_robust_success_rate"])
            if "eval_robust_success_rate" in eval_metrics
            else ""
        )
        stage_part = (
            " stage %.2f%%" % (100 * eval_metrics["eval_stage_success_rate"])
            if "eval_stage_success_rate" in eval_metrics
            else ""
        )
        self.logger.info(
            "eval @ %s: success %.2f%% reward %.1f crash %.2f%%%s%s",
            f"{self.env_steps:,}",
            100 * eval_metrics["eval_success_rate"],
            eval_metrics["eval_reward_mean"],
            100 * eval_metrics["eval_crash_rate"],
            robust_part,
            stage_part,
        )
        # eval-driven promotion, gated on the stage eval (the stage's own
        # randomization at dr_prob 1) when one exists
        promoted = self.curriculum.update_eval(
            eval_metrics.get(
                "eval_stage_success_rate",
                eval_metrics["eval_success_rate"],
            )
        )
        if promoted:
            stage = self.curriculum.get_environment_config()
            self.env_params = build_env_params(self.cfg, stage)
            self.stage_eval_env_params = self._build_stage_eval_params()
            forced = bool(
                self.curriculum.history
                and self.curriculum.history[-1].get("forced")
            )
            if forced:
                self.logger.warning(
                    "curriculum FORCE-promoted to stage %d (%s): stage "
                    "budget max_stage_steps=%s exhausted without clearing "
                    "the gate (stage-eval max %.3f vs threshold %.2f)",
                    self.curriculum.stage_idx,
                    stage.name if stage else "graduated",
                    f"{self.cfg.curriculum.max_stage_steps:,}",
                    self.curriculum.history[-1].get("stage_eval_max", 0.0),
                    self.curriculum.history[-1].get("threshold", float("nan")),
                )
            else:
                self.logger.info(
                    "curriculum advanced to stage %d (%s) [eval-driven]",
                    self.curriculum.stage_idx,
                    stage.name if stage else "graduated",
                )
            # the stage-eval tiebreak changes distribution at every
            # promotion; the robust eval (when configured) does not
            if "eval_robust_success_rate" not in eval_metrics:
                self.best_nominal_key = (
                    self.best_nominal_key[0],
                    float("-inf"),
                )
        else:
            alert = self.curriculum.watchdog_alert()
            if alert:
                self.logger.warning(alert)
        # secondary best capture on the lexicographic (nominal, robust-or-
        # stage) key when the primary metric is another one; the promoting
        # round's stage score was measured on the old stage and does not
        # seed the fresh tiebreak
        stage_tiebreak = (
            float("-inf")
            if promoted
            else eval_metrics.get("eval_stage_success_rate", float("-inf"))
        )
        nominal_key = (
            eval_metrics["eval_success_rate"],
            eval_metrics.get("eval_robust_success_rate", stage_tiebreak),
        )
        if (
            cfg.early_stopping.metric != "eval_success_rate"
            and cfg.checkpointing.save_best
            and nominal_key > self.best_nominal_key
        ):
            self.best_nominal_key = nominal_key
            self._save(self.ckpt_best_nominal, self.env_steps)
            self.logger.info(
                "new best (eval_success_rate=%.3f, tiebreak=%.3f) "
                "— nominal checkpoint saved",
                nominal_key[0],
                nominal_key[1],
            )
        metric = eval_metrics.get(
            cfg.early_stopping.metric, eval_metrics["eval_success_rate"]
        )
        # best capture fires on any improvement; min_improvement only gates
        # the early-stopping patience counter
        if metric > self.best_metric:
            self.best_metric = metric
            if cfg.checkpointing.save_best:
                self._save(self.ckpt_best, self.env_steps)
                self.logger.info(
                    "new best %s=%.3f — checkpoint saved",
                    cfg.early_stopping.metric,
                    metric,
                )
        # patience tracks a separate baseline that moves only on gains above
        # min_improvement
        if (
            metric
            > self.best_significant_metric
            + cfg.early_stopping.min_improvement
        ):
            self.best_significant_metric = metric
            self.eval_rounds_since_improvement = 0
        else:
            self.eval_rounds_since_improvement += 1
            if (
                cfg.early_stopping.enabled
                and self.eval_rounds_since_improvement
                >= cfg.early_stopping.patience
            ):
                self.logger.info(
                    "early stopping after %d eval rounds w/o improvement",
                    self.eval_rounds_since_improvement,
                )
                return "early_stopping"
        return None

    # ------------------------------------------------------------------ eval
    def _build_stage_eval_params(self):
        """Promotion-gate eval env: the current stage's randomization at
        dr_prob 1 (None when the curriculum is off or graduated, or
        randomization is off: then the nominal eval gates promotion)."""
        stage = self.curriculum.get_environment_config()
        if stage is None or not self.cfg.env.domain_randomization.enabled:
            return None
        stage = copy.deepcopy(stage)
        if stage.dr_prob is not None:
            stage.dr_prob = 1.0
        stage_cfg = copy.deepcopy(self.cfg)
        stage_cfg.env.domain_randomization.dr_prob = 1.0
        stage_cfg.env.domain_randomization.sensor_noise_enabled = (
            self.cfg.training.eval_sensor_noise
        )
        return build_env_params(stage_cfg, stage)

    def evaluate_on_rank0(self) -> dict[str, float]:
        """``evaluate()``; under data parallelism on rank 0 alone, its
        metrics and the trainer generator's state then broadcast, so every
        rank applies the same outcome and draws alike afterwards."""
        if self.world == 1:
            return self.evaluate()
        out = (self.evaluate(), self.generator.get_state()) if self.rank == 0 else None
        metrics, gen_state = mesh.broadcast_object(out)
        self.generator.set_state(gen_state)
        return metrics

    def evaluate(self) -> dict[str, float]:
        # the EMA (Polyak) actor when enabled (sac.eval_actor_view)
        agent = sac_mod.eval_actor_view(self.carry.agent, self.sac_cfg)
        if self.loop_cfg.use_hierarchical:
            agent = (agent, self.carry.hier)
        metrics = summarize_stats(self._eval_fn(agent, self.generator, self.eval_env_params))
        if self.robust_eval_env_params is not None:
            robust = summarize_stats(
                self._eval_fn(agent, self.generator, self.robust_eval_env_params)
            )
            metrics.update(
                {k.replace("eval_", "eval_robust_", 1): v for k, v in robust.items()}
            )
        if self.stage_eval_env_params is not None:
            stage = summarize_stats(
                self._eval_fn(agent, self.generator, self.stage_eval_env_params)
            )
            metrics["eval_stage_success_rate"] = stage["eval_success_rate"]
            metrics["eval_stage_reward_mean"] = stage["eval_reward_mean"]
        return metrics
