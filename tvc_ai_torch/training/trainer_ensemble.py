"""Ensemble trainer: PPO, SAC and TD3 on one shared batched simulator.

Counterpart of ``tvc_ai_tpu/training/trainer_ensemble.py``. Each host
iteration (a) asks the selector which member acts (or takes
``forced_actor``: PPO or TD3 trained alone, the off-policy members still
learning from the shared replay), (b) runs that member's iteration of
``agents.ensemble`` for ``rollout_steps`` × N envs (K1 for the physics on
the card), then (c) credits the finished episodes' mean return to the
acting member (to every member after a blended rollout) and feeds the
curriculum's statistics and the reward-hacking detector. Every member is
evaluated deterministically (the SAC member through
``sac.eval_actor_view``) on the nominal task without randomization or
sensor noise.

As in the reference, the environment parameters are built once: the
curriculum's statistics are fed but its stage is never applied.

The host reads the device once per iteration (the metrics and four
counter sums, in one transfer), which also ends the ``train_iteration``
stage of ``StageTimer`` after the device has finished. At the end it writes
``final_metrics.json`` and the members to ``ensemble_final.pt``
(``MultiAlgorithmAgent.save_checkpoint``); ``resume`` reads such a file.

Data parallel, by the SAC trainer's rule on ``hardware.mesh_devices``
(``training.trainer``): at a world above 1 each rank runs
``mesh.make_sharded_ensemble_train``'s iterations on its shard, the counter
sums of the one host read are summed over the ranks, and everything that
picks the acting member is the same on every rank (the performance windows
fed from the global counters, the selector's epsilon generator, which every
rank draws from alike). Rank 0 evaluates the members and broadcasts their
metrics with the trainer generator's state; every rank then runs the
selector. Rank 0 logs and writes ``final_metrics.json`` and the members'
checkpoint (replicated, so one file holds them).
"""

from __future__ import annotations

import copy
import time
from pathlib import Path

import torch

from tvc_ai_torch.agents import ensemble as ens
from tvc_ai_torch.agents import ppo as ppo_mod
from tvc_ai_torch.agents import sac as sac_mod
from tvc_ai_torch.agents import td3 as td3_mod
from tvc_ai_torch.config.build import build_env_params, build_sac_config
from tvc_ai_torch.config.schema import FrameworkConfig
from tvc_ai_torch.eval.rollout import make_policy_eval_fn, summarize_stats
from tvc_ai_torch.parallel import mesh
from tvc_ai_torch.training.curriculum import CurriculumManager
from tvc_ai_torch.training.hacking import RewardHackingDetector
from tvc_ai_torch.training.trainer import agreed_output_dir
from tvc_ai_torch.utils.checkpoint import save_json
from tvc_ai_torch.utils.devices import DEFAULT_DEVICE, resolve_device
from tvc_ai_torch.utils.logging import SilentLogger, TrainingLogger
from tvc_ai_torch.utils.profiling import StageTimer

FINAL_CHECKPOINT = "ensemble_final.pt"


def build_ensemble_config(cfg: FrameworkConfig) -> ens.EnsembleConfig:
    """The members' configs as the reference builds them: the full SAC
    config, TD3 from ``algorithms.td3`` (its clip norm at the default),
    PPO with the SAC hidden widths, γ 0.99 and a constant lr."""
    a = cfg.algorithms
    return ens.EnsembleConfig(
        algorithms=tuple(a.ensemble.algorithms),
        selection_strategy=a.ensemble.selection_strategy,
        performance_window=a.ensemble.performance_window,
        selection_epsilon=a.ensemble.selection_epsilon,
        sac=build_sac_config(cfg),
        td3=td3_mod.TD3Config(
            hidden_dims=tuple(a.td3.hidden_dims),
            lr=a.td3.learning_rate,
            gamma=a.td3.gamma,
            tau=a.td3.tau,
            batch_size=a.td3.batch_size,
            policy_delay=a.td3.policy_delay,
            target_policy_noise=a.td3.target_policy_noise,
            target_noise_clip=a.td3.target_noise_clip,
            exploration_noise=a.td3.exploration_noise,
        ),
        ppo=ppo_mod.PPOConfig(
            hidden_dims=tuple(a.sac.hidden_dims),
            learning_rate=a.ppo.learning_rate,
            gamma=0.99,
            gae_lambda=a.ppo.gae_lambda,
            clip_range=a.ppo.clip_range,
            ent_coef=a.ppo.ent_coef,
            vf_coef=a.ppo.vf_coef,
            max_grad_norm=a.ppo.max_grad_norm,
            n_epochs=a.ppo.n_epochs,
        ),
    )


class EnsembleTrainer:
    def __init__(
        self,
        cfg: FrameworkConfig,
        output_dir: str | Path | None = None,
        resume: str | Path | None = None,
        forced_actor: str | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.world = mesh.resolve_world(cfg.hardware.mesh_devices)
        if forced_actor not in (None, *ens.ACTORS):
            raise ValueError(f"forced_actor={forced_actor!r}; want one of {ens.ACTORS}")
        self.cfg = cfg
        self.forced_actor = forced_actor
        self.ens_cfg = build_ensemble_config(cfg)
        self.device = (mesh.init_data_parallel(device) if self.world > 1
                       else resolve_device(device))
        self.rank = mesh.rank()
        self.axis = mesh.DATA_AXIS if self.world > 1 else None
        self.output_dir = agreed_output_dir(output_dir, cfg.globals.output_dir,
                                            cfg.globals.experiment_name + "_ensemble")
        self.logger = TrainingLogger(
            self.output_dir, level=cfg.logging.level,
            tensorboard=cfg.logging.tensorboard, csv_enabled=cfg.logging.csv,
        ) if self.rank == 0 else SilentLogger(self.output_dir)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.globals.seed)
        self.curriculum = CurriculumManager(cfg)
        self.hacking = RewardHackingDetector()
        self.agent = ens.MultiAlgorithmAgent(config=self.ens_cfg, device=self.device)
        self.env_params = build_env_params(cfg, self.curriculum.get_environment_config())
        # eval on the nominal task without randomization or sensor noise
        eval_cfg = copy.deepcopy(cfg)
        eval_cfg.env.domain_randomization.enabled = False
        eval_cfg.env.domain_randomization.sensor_noise_enabled = False
        self.eval_env_params = build_env_params(eval_cfg)

        n, t = cfg.training.num_envs, cfg.training.rollout_steps
        if self.world > 1:
            init_fn, self._iterations = mesh.make_sharded_ensemble_train(
                self.env_params, self.ens_cfg, n, t, cfg.training.updates_per_step, self.device)
            self.carry = init_fn(self._next_seed())
        else:
            self.carry = ens.init_carry(self.env_params, self.ens_cfg, n, self.device,
                                        seed=self._next_seed())
            self._iterations = {
                actor: ens.make_ensemble_iteration(actor, self.ens_cfg, n, t,
                                                   cfg.training.updates_per_step)
                for actor in ens.ACTORS
            }
        self.agent.attach_carry(self.carry)
        episodes, td3_cfg = cfg.training.eval_episodes, self.ens_cfg.td3
        self._eval_fns = {
            "sac": make_policy_eval_fn(
                lambda s, o: sac_mod.select_action(s.actor, o, deterministic=True), episodes),
            "td3": make_policy_eval_fn(
                lambda s, o: td3_mod.select_action(s.actor, o, td3_cfg, deterministic=True),
                episodes),
            "ppo": make_policy_eval_fn(
                lambda s, o: ppo_mod.select_action(s, o, deterministic=True), episodes),
        }
        if self.world > 1:
            self.logger.info("ensemble data parallel: %d ranks (%s)", self.world,
                             torch.distributed.get_backend())
        else:
            self.logger.info("single device: %s", self.device)
        self.timer = StageTimer()
        self._last_episodes = 0
        self._last_successes = 0
        self._last_return_sum = 0.0
        self.iteration = 0
        if resume is not None:
            self.agent.load_checkpoint(resume)
            self.carry = self.agent.carry
            self.logger.info("resumed ensemble members from %s", resume)

    def _next_seed(self) -> int:
        """A seed drawn from the trainer's generator (the reference splits its key)."""
        return int(torch.randint(2**62, (), generator=self.generator, device=self.device))

    @property
    def env_steps(self) -> int:
        return int(mesh.psum_host([self.carry.env_steps.sum()], self.axis)[0])

    def train(self) -> dict:
        cfg = self.cfg.training
        steps_per_iter = cfg.num_envs * cfg.rollout_steps
        eval_every = max(cfg.eval_freq // steps_per_iter, 1)
        t_start = time.perf_counter()
        self.logger.info(
            "ensemble training: %s steps, strategy=%s",
            f"{cfg.total_timesteps:,}",
            self.ens_cfg.selection_strategy,
        )
        env_steps = self.env_steps
        while env_steps < cfg.total_timesteps:
            actor = self.forced_actor or self.agent.select_algorithm()
            with self.timer.stage("train_iteration"):
                self.carry, metrics = self._iterations[actor](
                    self.carry, self.agent.weights_array(), self.env_params)
                # the host's one read of the device this iteration
                counters = (self.carry.env_steps, self.carry.episodes, self.carry.successes,
                            self.carry.return_sum)
                sums = mesh.psum_(torch.stack([c.sum().double() for c in counters]), self.axis)
                *values, env_steps, episodes, successes, return_sum = torch.cat(
                    [torch.stack([v.double() for v in metrics.values()]), sums]).tolist()
            self.agent.attach_carry(self.carry)
            self.iteration += 1
            env_steps, episodes, successes = int(env_steps), int(episodes), int(successes)

            ep_delta = episodes - self._last_episodes
            if ep_delta > 0:
                mean_ret = (return_sum - self._last_return_sum) / ep_delta
                rate = (successes - self._last_successes) / ep_delta
                # credit the acting algorithm; a blended ("ensemble") rollout
                # credits every member (they all contributed to the action)
                credited = self.ens_cfg.algorithms if actor == "ensemble" else (actor,)
                for algo in credited:
                    self.agent.update_performance(algo, mean_ret)
                self.curriculum.update(ep_delta, rate)
                self.hacking.add_episode(mean_ret, rate > 0.5, 500)
            self._last_episodes = episodes
            self._last_successes = successes
            self._last_return_sum = return_sum

            metrics = dict(zip(metrics, values))
            metrics["env_steps"] = env_steps
            metrics["actor_is_ppo"] = float(actor == "ppo")
            self.logger.log_metrics(env_steps, metrics)
            if self.iteration % self.cfg.logging.log_freq_iterations == 0:
                self.logger.progress_line(
                    env_steps, cfg.total_timesteps,
                    {"reward_mean": metrics.get("reward_mean", 0.0),
                     "alpha": metrics.get("alpha", 0.0)},
                )
                self.logger.info("acting algorithm: %s", actor)

            if self.iteration % eval_every == 0:
                with self.timer.stage("evaluate"):
                    eval_metrics = self.evaluate()
                self.logger.log_metrics(env_steps, eval_metrics)
                self.logger.info(
                    "eval: %s",
                    {k: round(v, 3) for k, v in eval_metrics.items()
                     if k.endswith(("success_rate", "reward_mean"))},
                )

        elapsed = time.perf_counter() - t_start
        with self.timer.stage("evaluate"):
            final_eval = self.evaluate()
        with self.timer.stage("checkpoint"):
            if self.rank == 0:
                self.agent.save_checkpoint(self.output_dir / FINAL_CHECKPOINT)
            mesh.barrier()
        result = {
            "env_steps": env_steps,
            "iterations": self.iteration,
            "wallclock_sec": elapsed,
            "steps_per_sec": env_steps / max(elapsed, 1e-9),
            "algorithm_weights": dict(self.agent.algorithm_weights),
            "stage_timing": self.timer.report(),
            **final_eval,
        }
        if self.rank == 0:
            save_json(self.output_dir / "final_metrics.json", result)
        self.logger.info("stage timing: %s", self.timer.summary_line())
        self.logger.close()
        return result

    def evaluate(self) -> dict[str, float]:
        """Evaluate every member's deterministic policy (one rollout each);
        the headline is the member the selector picks now. Under data
        parallelism rank 0 runs the rollouts and broadcasts their metrics
        with the trainer generator's state; every rank runs the selector."""
        # the SAC member evaluates its EMA (Polyak) actor when enabled
        members = {
            "sac": sac_mod.eval_actor_view(self.carry.sac, self.ens_cfg.sac),
            "td3": self.carry.td3,
            "ppo": self.carry.ppo,
        }
        out: dict[str, float] = {}
        if self.rank == 0:
            for name, state in members.items():
                stats = self._eval_fns[name](state, self.generator, self.eval_env_params)
                for k, v in summarize_stats(stats).items():
                    out[f"{name}_{k}"] = v
        if self.world > 1:
            out, gen_state = mesh.broadcast_object(
                (out, self.generator.get_state()) if self.rank == 0 else None)
            self.generator.set_state(gen_state)
        best = self.agent.select_algorithm()
        best = best if best in members else "sac"
        out["eval_success_rate"] = out[f"{best}_eval_success_rate"]
        out["eval_reward_mean"] = out[f"{best}_eval_reward_mean"]
        return out
