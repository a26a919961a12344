"""Training logger: console + ``training.log`` + ``metrics.csv`` + TensorBoard
(``SilentLogger`` for the data-parallel ranks that do not log).

Counterpart of ``tvc_ai_tpu/utils/logging.py``. Metrics arrive aggregated
once per iteration (the trainer reads the device once per iteration), so
logging costs one host transfer per iteration, not per step. TensorBoard
(``tensorboardX``) and wandb are optional: when either does not import, the
logger warns and goes on without it. The TensorBoard tags are the
reference's: ``episode/reward``, ``episode/length``, ``episode/success``,
``training/actor_loss``, ``training/critic1_loss``, ``training/alpha``.
"""

from __future__ import annotations

import csv
import logging
import sys
import time
from pathlib import Path
from typing import Any


def make_output_dir(base: str | Path, experiment: str) -> Path:
    """Timestamped run dir: <base>/<experiment>/DATE/TIME."""
    stamp = time.strftime("%Y-%m-%d/%H-%M-%S")
    out = Path(base) / experiment / stamp
    out.mkdir(parents=True, exist_ok=True)
    return out


class TrainingLogger:
    def __init__(
        self,
        output_dir: str | Path,
        level: str = "INFO",
        tensorboard: bool = True,
        csv_enabled: bool = True,
        wandb_enabled: bool = False,
        wandb_mode: str = "offline",
        wandb_config: dict | None = None,
    ):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.logger = logging.getLogger("tvc_ai_torch")
        self.logger.setLevel(getattr(logging, level.upper(), logging.INFO))
        self.logger.handlers.clear()
        fmt = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s")
        for handler in (
            logging.StreamHandler(sys.stdout),
            logging.FileHandler(self.output_dir / "training.log"),
        ):
            handler.setFormatter(fmt)
            self.logger.addHandler(handler)
        self.logger.propagate = False

        self._tb = None
        if tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(str(self.output_dir / "tb"))
            except Exception as exc:  # pragma: no cover - optional dep
                self.logger.warning("tensorboard disabled: %s", exc)

        # wandb (offline by default; disabled with a warning when absent)
        self._wandb = None
        if wandb_enabled:
            try:
                import os

                os.environ.setdefault("WANDB_MODE", wandb_mode)
                import wandb

                self._wandb = wandb.init(
                    project="tvc-ai-torch",
                    dir=str(self.output_dir),
                    config=wandb_config or {},
                    mode=wandb_mode,
                )
            except Exception as exc:  # pragma: no cover - optional dep
                self.logger.warning("wandb disabled: %s", exc)

        self._csv_path = self.output_dir / "metrics.csv" if csv_enabled else None
        self._csv_fields: list[str] | None = None
        self._history: list[dict[str, float]] = []
        self._t0 = time.perf_counter()
        self._last_steps = 0

    # ----------------------------------------------------------------- sinks
    def info(self, msg: str, *args) -> None:
        self.logger.info(msg, *args)

    def warning(self, msg: str, *args) -> None:
        self.logger.warning(msg, *args)

    def log_metrics(self, step: int, metrics: dict[str, Any]) -> None:
        metrics = {k: float(v) for k, v in metrics.items()}
        self._history.append({"step": step, **metrics})
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(self._tb_tag(k), v, step)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._csv_path is not None:
            self._write_csv(step, metrics)

    @staticmethod
    def _tb_tag(key: str) -> str:
        mapping = {
            "mean_episode_return": "episode/reward",
            "mean_episode_length": "episode/length",
            "success_rate": "episode/success",
            "actor_loss": "training/actor_loss",
            "critic_loss": "training/critic1_loss",
            "alpha": "training/alpha",
        }
        return mapping.get(key, f"metrics/{key}")

    def _write_csv(self, step: int, metrics: dict[str, float]) -> None:
        row = {"step": step, **metrics}
        new_file = self._csv_fields is None
        if new_file:
            self._csv_fields = list(row)
        elif any(k not in self._csv_fields for k in row):
            # new metric keys after the first write (eval columns after
            # the first training row): widen the header and rewrite the
            # file once, so no later column is dropped
            self._csv_fields += [k for k in row if k not in self._csv_fields]
            old_rows = []
            if self._csv_path.exists():
                with open(self._csv_path, newline="") as f:
                    old_rows = list(csv.DictReader(f))
            with open(self._csv_path, "w", newline="") as f:
                writer = csv.DictWriter(
                    f, fieldnames=self._csv_fields, extrasaction="ignore"
                )
                writer.writeheader()
                writer.writerows(old_rows)
        with open(self._csv_path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._csv_fields, extrasaction="ignore")
            if new_file:
                writer.writeheader()
            writer.writerow(row)

    # ------------------------------------------------------------- telemetry
    def progress_line(self, step: int, total: int, metrics: dict[str, Any]) -> None:
        """Per-iteration console line with steps/s + host telemetry."""
        now = time.perf_counter()
        sps = (step - self._last_steps) / max(now - self._t0, 1e-9)
        self._t0, self._last_steps = now, step
        telem = ""
        try:
            import psutil

            telem = (
                f" | cpu {psutil.cpu_percent():.0f}%"
                f" ram {psutil.virtual_memory().percent:.0f}%"
            )
        except Exception:
            pass
        parts = " ".join(
            f"{k}={float(v):.3f}" for k, v in metrics.items() if v == v
        )
        self.info(
            f"step {step:,}/{total:,} ({sps:,.0f} steps/s){telem} | {parts}"
        )

    # ---------------------------------------------------------------- plots
    def save_plots(self) -> None:
        """4-panel training summary PNG."""
        if not self._history:
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            steps = [h["step"] for h in self._history]

            def series(key):
                return [h.get(key, float("nan")) for h in self._history]

            fig, axes = plt.subplots(2, 2, figsize=(12, 8))
            panels = [
                ("mean_episode_return", "Episode reward"),
                ("success_rate", "Success rate"),
                ("critic_loss", "Critic loss"),
                ("alpha", "Entropy temperature α"),
            ]
            for ax, (key, title) in zip(axes.flat, panels):
                ax.plot(steps, series(key))
                ax.set_title(title)
                ax.set_xlabel("env steps")
                ax.grid(alpha=0.3)
            fig.tight_layout()
            fig.savefig(self.output_dir / "training_summary.png", dpi=120)
            plt.close(fig)
        except Exception as exc:  # pragma: no cover
            self.logger.warning("plot generation failed: %s", exc)

    def close(self) -> None:
        self.save_plots()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
        for h in list(self.logger.handlers):
            h.close()
            self.logger.removeHandler(h)


class SilentLogger:
    """The logger of a data-parallel rank other than 0: the same calls,
    nothing written (rank 0 logs for the group)."""

    def __init__(self, output_dir: str | Path):
        self.output_dir = Path(output_dir)

    def info(self, msg: str, *args) -> None:
        pass

    warning = info

    def log_metrics(self, step: int, metrics: dict[str, Any]) -> None:
        pass

    def progress_line(self, step: int, total: int, metrics: dict[str, Any]) -> None:
        pass

    def save_plots(self) -> None:
        pass

    def close(self) -> None:
        pass
