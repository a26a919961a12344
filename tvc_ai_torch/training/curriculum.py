"""Adaptive staged curriculum — stage conditions actually applied.

Counterpart of ``tvc_ai_tpu/training/curriculum.py``, a host-only copy: the
manager picks the stage whose conditions (wind, mass variation, initial tilt,
sensor noise, gimbal limit) ``config.build.build_env_params`` overlays, and
the trainer rebuilds its env parameters on promotion.

Promotion rule: at least ``min_stage_fraction`` of the stage's episode budget
must have elapsed AND the rolling success rate must beat the stage
threshold; the eval-driven path (``update_eval``) gates on the window max of
the stage's own evaluation, with a dwell, a bounded stage budget and a
watchdog. ``load_state_dict`` resets the rolling windows and the watchdog.
"""

from __future__ import annotations

import json
from collections import deque
from pathlib import Path

from tvc_ai_torch.config.schema import CurriculumConfig, CurriculumStage, FrameworkConfig


class CurriculumManager:
    def __init__(self, cfg: FrameworkConfig):
        self.cfg = cfg
        self.cur: CurriculumConfig = cfg.curriculum
        self.stage_idx = 0
        self.episodes_in_stage = 0
        self.steps_in_stage = 0
        self.success_window: deque[float] = deque(maxlen=self.cur.stability_window)
        # deterministic-eval success window (the reference drives promotion
        # from eval_metrics, curriculum_manager.py:248 — training-rollout
        # success under stochastic actions rarely clears the 100-consecutive-
        # step criterion, so an eval-driven path is required in practice)
        self.eval_window: deque[float] = deque(
            maxlen=max(3, self.cur.stability_window // 10)
        )
        # watchdog state: stage evals seen / best stage-eval score since
        # entering the current stage (survives the rolling window's maxlen)
        self.evals_in_stage = 0
        self.stage_eval_max = 0.0
        self.history: list[dict] = []

    # ------------------------------------------------------------ queries
    @property
    def enabled(self) -> bool:
        return self.cur.enabled and len(self.cur.stages) > 0

    @property
    def stage(self) -> CurriculumStage:
        return self.cur.stages[min(self.stage_idx, len(self.cur.stages) - 1)]

    @property
    def finished(self) -> bool:
        return self.stage_idx >= len(self.cur.stages)

    def get_environment_config(self) -> CurriculumStage | None:
        """Stage overlay for ``config.build.build_env_params`` (or None)."""
        if not self.enabled or self.finished:
            return None
        return self.stage

    def get_adaptive_hyperparameters(self) -> dict:
        """Per-stage hyperparameters (ref curriculum_manager.py:330-356)."""
        schedule = [
            {"batch_size": 128, "train_freq": 4, "exploration_noise": 0.3},
            {"batch_size": 256, "train_freq": 8, "exploration_noise": 0.2},
            {"batch_size": 512, "train_freq": 10, "exploration_noise": 0.1},
        ]
        tier = min(self.stage_idx * len(schedule) // max(len(self.cur.stages), 1),
                   len(schedule) - 1)
        return schedule[tier]

    # ------------------------------------------------------------ updates
    def update(
        self, episodes_finished: int, success_rate: float, env_steps: int = 0
    ) -> bool:
        """Feed rolling stats; returns True if the stage advanced.

        Signature fixed vs the reference's step/success_rate confusion:
        callers pass the number of episodes finished since last update and
        the success rate over them (plus optionally env steps elapsed, which
        feeds the ``min_stage_steps`` promotion dwell).
        """
        if not self.enabled or self.finished:
            return False
        self.episodes_in_stage += int(episodes_finished)
        self.steps_in_stage += int(env_steps)
        if episodes_finished > 0:
            self.success_window.append(float(success_rate))
        if self.should_advance_stage():
            self.advance_stage()
            return True
        return False

    def update_eval(self, eval_success_rate: float) -> bool:
        """Feed a deterministic-eval success rate (ref promotion signal,
        curriculum_manager.py:248 ``update(step, eval_metrics)``); returns
        True if the stage advanced.

        The gate is the window MAX, not the mean: at training LR the policy
        oscillates across the success knife edge (measured 0% ↔ 90%+ between
        adjacent evals; evals only stabilize once the LR schedule decays,
        far too late for staged promotion), so repeatedly *demonstrating*
        the threshold is the meaningful capability signal — the dips are
        high-LR artifacts, not inability."""
        if not self.enabled or self.finished:
            return False
        # bounded stage budget (max_stage_steps): force-promote rather than
        # silently burn the campaign on one unreachable gate (the r4c
        # failure: calm-stage threshold 0.8 vs a measured stage-eval max of
        # 59% → 80M steps pinned at stage 0). Checked before the dwell gate
        # — a stage that exhausted its budget is past any dwell by design.
        if (
            self.cur.max_stage_steps > 0
            and self.steps_in_stage >= self.cur.max_stage_steps
        ):
            self.advance_stage(forced=True)
            return True
        if self.steps_in_stage < self.cur.min_stage_steps:
            # dwell: must actually train at this difficulty; evals from the
            # dwell period are NOT appended, else the first post-dwell eval
            # could promote on stale pre-dwell evidence
            return False
        self.eval_window.append(float(eval_success_rate))
        self.evals_in_stage += 1
        self.stage_eval_max = max(self.stage_eval_max, float(eval_success_rate))
        if len(self.eval_window) >= 3:
            if max(self.eval_window) >= self.stage.success_threshold:
                self.advance_stage()
                return True
        return False

    def watchdog_alert(self) -> str | None:
        """Unreachable-gate detector: after ``watchdog_evals`` post-dwell
        stage evals, if the best stage-eval score is still below
        ``watchdog_fraction`` of the stage threshold, the gate is almost
        certainly miscalibrated (stage-eval oscillation at training LR
        spans 0↔max within a few evals, so the running max IS the
        capability estimate). Returns a warning string, or None."""
        if not self.enabled or self.finished:
            return None
        if self.evals_in_stage < self.cur.watchdog_evals:
            return None
        bar = self.cur.watchdog_fraction * self.stage.success_threshold
        if self.stage_eval_max >= bar:
            return None
        return (
            f"promotion-gate watchdog: stage {self.stage_idx} "
            f"({self.stage.name}) has had {self.evals_in_stage} stage evals "
            f"with max {self.stage_eval_max:.3f} — far below its "
            f"success_threshold {self.stage.success_threshold:.2f} "
            f"(< {self.cur.watchdog_fraction:.0%} of it). The gate looks "
            f"unreachable; the campaign may burn its budget at this stage "
            f"(set curriculum.max_stage_steps or lower the threshold)."
        )

    def should_advance_stage(self) -> bool:
        if self.finished:
            return False
        stage = self.stage
        if self.steps_in_stage < self.cur.min_stage_steps:
            return False  # same dwell the eval path enforces
        if self.episodes_in_stage < stage.episodes * self.cur.min_stage_fraction:
            return False
        if len(self.success_window) < max(3, self.cur.stability_window // 10):
            return False
        import numpy as np

        rolling = float(np.mean(self.success_window))
        # promotion strictly on merit (ref :248-307 advances only when the
        # success criteria are met; a budget-exhaustion hard cap promotes at
        # 0 % success within seconds at 512 parallel envs, because episode
        # budgets sized for single-env training elapse ~512x faster)
        return rolling >= stage.success_threshold

    def advance_stage(self, forced: bool = False) -> None:
        self.history.append(
            {
                "stage": self.stage.name,
                "episodes": self.episodes_in_stage,
                "final_success": (
                    float(sum(self.success_window) / len(self.success_window))
                    if self.success_window
                    else 0.0
                ),
                "stage_eval_max": self.stage_eval_max,
                "threshold": self.stage.success_threshold,
                "forced": forced,
            }
        )
        self.stage_idx += 1
        self.episodes_in_stage = 0
        self.steps_in_stage = 0
        self.success_window.clear()
        self.eval_window.clear()
        self.evals_in_stage = 0
        self.stage_eval_max = 0.0

    # ------------------------------------------------------------ persistence
    def state_dict(self) -> dict:
        return {
            "stage_idx": self.stage_idx,
            "episodes_in_stage": self.episodes_in_stage,
            "steps_in_stage": self.steps_in_stage,
            "success_window": list(self.success_window),
            "eval_window": list(self.eval_window),
            "evals_in_stage": self.evals_in_stage,
            "stage_eval_max": self.stage_eval_max,
            "history": self.history,
        }

    def load_state_dict(self, d: dict) -> None:
        self.stage_idx = int(d.get("stage_idx", 0))
        self.episodes_in_stage = int(d.get("episodes_in_stage", 0))
        self.steps_in_stage = int(d.get("steps_in_stage", 0))
        # the rolling windows are SIGNAL buffers, not progress: a checkpoint
        # may be resumed into a different campaign (new stages / promotion
        # gate), where inherited evidence would promote spuriously on the
        # first post-resume eval (measured: a 100%-nominal window resumed
        # into a DR campaign). They refill within a few evals.
        self.success_window = deque([], maxlen=self.cur.stability_window)
        self.eval_window = deque(
            [], maxlen=max(3, self.cur.stability_window // 10)
        )
        # watchdog counters reset with the windows (same rationale: they are
        # evidence about the OLD campaign's gate, not the resumed one's)
        self.evals_in_stage = 0
        self.stage_eval_max = 0.0
        self.history = list(d.get("history", []))

    def save_curriculum_data(self, path) -> None:
        """Stats JSON, like the reference's save_curriculum_data (:358-376)."""
        Path(path).write_text(json.dumps(self.state_dict(), indent=2))
