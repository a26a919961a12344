"""Training-log plots.

Counterpart of ``tvc_ai_tpu/viz/visualize.py``: reads a run's metrics from
the trainer's ``metrics.csv`` (always written by ``utils.logging.
TrainingLogger``) or, failing that, from its TensorBoard event files under
``tb/`` (when the ``tensorboard`` package imports), and renders the six key
metric plots (episode/reward, episode/length, episode/success,
training/actor_loss, training/critic1_loss, training/alpha) plus a
reward-distribution analysis with matplotlib; a run with nothing to plot
gets a "no data" report instead. ``KEY_METRICS`` maps each TensorBoard tag
to its CSV column, as the logger's ``_tb_tag`` does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

KEY_METRICS = {
    "episode/reward": "mean_episode_return",
    "episode/length": "mean_episode_length",
    "episode/success": "success_rate",
    "training/actor_loss": "actor_loss",
    "training/critic1_loss": "critic_loss",
    "training/alpha": "alpha",
}


def load_csv_metrics(csv_path: Path) -> dict[str, tuple[list, list]]:
    import csv as csv_mod

    series: dict[str, tuple[list, list]] = {}
    with open(csv_path) as f:
        for row in csv_mod.DictReader(f):
            step = float(row.get("step", 0))
            for key, col in KEY_METRICS.items():
                val = row.get(col)
                if val not in (None, ""):
                    series.setdefault(key, ([], []))
                    series[key][0].append(step)
                    series[key][1].append(float(val))
    return series


def load_tb_metrics(log_dir: Path) -> dict[str, tuple[list, list]]:
    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )
    except ImportError:
        return {}
    series: dict[str, tuple[list, list]] = {}
    for event_file in sorted(log_dir.rglob("events.out.tfevents.*")):
        acc = EventAccumulator(str(event_file.parent))
        acc.Reload()
        for tag in acc.Tags().get("scalars", []):
            if tag in KEY_METRICS:
                events = acc.Scalars(tag)
                series[tag] = (
                    [e.step for e in events],
                    [e.value for e in events],
                )
    return series


def create_plots(log_dir: str | Path, output_dir: str | Path) -> list[Path]:
    log_dir, output_dir = Path(log_dir), Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    series: dict[str, tuple[list, list]] = {}
    csv_path = log_dir / "metrics.csv"
    if csv_path.exists():
        series = load_csv_metrics(csv_path)
    if not series:
        series = load_tb_metrics(log_dir)
    artifacts: list[Path] = []
    if not series:
        report = output_dir / "no_data_report.txt"
        report.write_text(
            f"No metric data found under {log_dir}.\n"
            "Expected metrics.csv or TensorBoard event files.\n"
        )
        return [report]

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 3, figsize=(16, 8))
    for ax, (tag, _) in zip(axes.flat, KEY_METRICS.items()):
        if tag in series:
            steps, values = series[tag]
            ax.plot(steps, values)
        ax.set_title(tag)
        ax.set_xlabel("step")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    path = output_dir / "training_metrics.png"
    fig.savefig(path, dpi=110)
    plt.close(fig)
    artifacts.append(path)

    if "episode/reward" in series:
        _, rewards = series["episode/reward"]
        rewards = np.asarray(rewards)
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4))
        ax1.hist(rewards, bins=30)
        ax1.set_title("Reward distribution")
        window = max(len(rewards) // 20, 1)
        smoothed = np.convolve(rewards, np.ones(window) / window, mode="valid")
        ax2.plot(rewards, alpha=0.3, label="raw")
        ax2.plot(
            np.arange(len(smoothed)) + window - 1, smoothed, label="smoothed"
        )
        ax2.set_title("Reward trend")
        ax2.legend()
        for ax in (ax1, ax2):
            ax.grid(alpha=0.3)
        fig.tight_layout()
        path = output_dir / "reward_analysis.png"
        fig.savefig(path, dpi=110)
        plt.close(fig)
        artifacts.append(path)
    return artifacts
