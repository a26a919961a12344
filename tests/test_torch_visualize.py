"""The training plots of tvc_ai_torch against the JAX package (CPU).

The same ``metrics.csv`` gives equal series and the same artifacts in both
packages; the no-data report is the same; TensorBoard events written by the
port's ``TrainingLogger`` read the same through both packages'
``load_tb_metrics`` and render; ``python -m tvc_ai_torch.visualize``
prints its artifacts.
"""

from __future__ import annotations

import contextlib
import io

import numpy as np
import pytest

from tvc_ai_torch import visualize
from tvc_ai_torch.utils.logging import TrainingLogger
from tvc_ai_torch.viz import visualize as t_viz
from tvc_ai_tpu.viz import visualize as j_viz


def write_csv(run_dir):
    """The reference test's CSV, with an empty cell and a column no plot reads."""
    rows = ["step,mean_episode_return,success_rate,critic_loss,alpha,actor_loss,other"]
    for i in range(20):
        actor = "" if i % 5 == 0 else f"{-i * 0.5}"
        rows.append(f"{i * 100},{50 + i},{i / 20:.2f},{100 - i},{0.2},{actor},{i}")
    run_dir.mkdir(parents=True, exist_ok=True)
    (run_dir / "metrics.csv").write_text("\n".join(rows))
    return run_dir / "metrics.csv"


def test_key_metrics_are_the_loggers_tags():
    assert t_viz.KEY_METRICS == j_viz.KEY_METRICS
    assert {TrainingLogger._tb_tag(col): tag for tag, col in t_viz.KEY_METRICS.items()} == {
        tag: tag for tag in t_viz.KEY_METRICS}


def test_csv_series_and_artifacts_equal_the_reference(tmp_path):
    csv_path = write_csv(tmp_path / "run")
    series = t_viz.load_csv_metrics(csv_path)
    assert series == j_viz.load_csv_metrics(csv_path)
    assert len(series["training/actor_loss"][0]) == 16 and "episode/length" not in series
    port = t_viz.create_plots(tmp_path / "run", tmp_path / "t")
    ref = j_viz.create_plots(tmp_path / "run", tmp_path / "j")
    assert [a.name for a in port] == [a.name for a in ref] == [
        "training_metrics.png", "reward_analysis.png"]
    assert all(a.stat().st_size > 0 for a in port)


def test_no_data_report_equals_the_reference(tmp_path):
    (tmp_path / "empty").mkdir()
    port = t_viz.create_plots(tmp_path / "empty", tmp_path / "t")
    ref = j_viz.create_plots(tmp_path / "empty", tmp_path / "j")
    assert [a.name for a in port] == [a.name for a in ref] == ["no_data_report.txt"]
    assert port[0].read_bytes() == ref[0].read_bytes()


def test_logger_events_read_the_same_in_both_packages(tmp_path):
    pytest.importorskip("tensorboardX")
    run = tmp_path / "run"
    logger = TrainingLogger(run, csv_enabled=False)
    for i in range(6):
        logger.log_metrics(1000 * i, {"mean_episode_return": 10.0 + i, "success_rate": i / 10,
                                      "critic_loss": 5.0 - i, "alpha": 0.2, "fps": 99.0})
    logger._tb.close()
    series = t_viz.load_tb_metrics(run)
    assert series == j_viz.load_tb_metrics(run)
    assert sorted(series) == ["episode/reward", "episode/success", "training/alpha",
                              "training/critic1_loss"]
    steps, values = series["episode/reward"]
    assert steps == [1000 * i for i in range(6)]
    np.testing.assert_allclose(values, [10.0 + i for i in range(6)])
    # no CSV: the plots come from the events
    names = [a.name for a in t_viz.create_plots(run, tmp_path / "plots")]
    assert names == ["training_metrics.png", "reward_analysis.png"]


def test_command_prints_its_artifacts(tmp_path):
    write_csv(tmp_path / "run")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = visualize.main(["--log-dir", str(tmp_path / "run")])
    assert rc == 0
    assert out.getvalue().splitlines() == [
        str(tmp_path / "run" / "plots" / "training_metrics.png"),
        str(tmp_path / "run" / "plots" / "reward_analysis.png")]
