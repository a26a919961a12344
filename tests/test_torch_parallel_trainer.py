"""The trainers at world 2 under ``torchrun`` on the CPU (gloo).

``torchrun --standalone --nproc-per-node 2 -m tvc_ai_torch.train --device
cpu`` trains the tiny configuration of ``tests/test_torch_trainer.py``
(8 envs, 4 a rank, an eval round every iteration): it finishes, rank 0
alone writes the run's files, and every checkpoint step holds one carry
shard per rank and ``host.json``. Resumed at world 2 from its checkpoint for
one more iteration, it ends with the carries of three straight iterations,
shard by shard, bit for bit; resumed in a single process it is refused.
``training.algorithm=ensemble`` runs ``EnsembleTrainer`` at world 2 with
``hardware.mesh_devices=2``, and ``hardware.mesh_devices=1`` refuses a world
of 2.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from test_torch_trainer import tiny_cfg, tiny_overrides
from tvc_ai_torch.training.trainer import Trainer
from tvc_ai_torch.utils.checkpoint import CheckpointManager, diff_states

ROOT = Path(__file__).resolve().parent.parent
STEPS_PER_ITER = 8 * 16
EVERY_ITERATION = ["training.eval_freq=128"]


def torchrun(tmp_path, name: str, total: int, extra=(), resume=None, nproc: int = 2):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", "-m", "tvc_ai_torch.train", "--device", "cpu",
           "--output-dir", str(tmp_path / name)]
    if resume is not None:
        cmd += ["--resume", str(resume)]
    cmd += [*tiny_overrides(tmp_path, total), *EVERY_ITERATION, *extra]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)


def final_shards(run_dir: Path) -> list:
    mngr = CheckpointManager(run_dir / "checkpoints")
    step = mngr.latest_step()
    assert mngr.world_of(step) == 2
    return [mngr.restore(step, "cpu", rank=r, world=2)[0]["carry"] for r in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_trainer")
    first = torchrun(tmp, "first", 2 * STEPS_PER_ITER)
    assert first.returncode == 0, first.stderr[-3000:]
    resumed = torchrun(tmp, "resumed", 3 * STEPS_PER_ITER, resume=tmp / "first" / "checkpoints")
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    straight = torchrun(tmp, "straight", 3 * STEPS_PER_ITER)
    assert straight.returncode == 0, straight.stderr[-3000:]
    return tmp, first, resumed, straight


def test_torchrun_world2_trains(runs):
    tmp, first, _, _ = runs
    assert first.stdout.count("final: success=") == 1   # rank 0 prints
    final = json.loads((tmp / "first" / "final_metrics.json").read_text())
    assert final["env_steps"] == 2 * STEPS_PER_ITER and final["iterations"] == 2
    header = (tmp / "first" / "metrics.csv").read_text().splitlines()[0].split(",")
    assert {"critic_loss", "success_rate_recent", "eval_success_rate"} <= set(header)
    assert "data parallel: 2 ranks (gloo), 4 envs each" in (tmp / "first" / "training.log").read_text()
    mngr = CheckpointManager(tmp / "first" / "checkpoints")
    step_dir = mngr.directory / str(mngr.latest_step())
    assert sorted(p.name for p in step_dir.iterdir()) == ["carry.rank0.pt", "carry.rank1.pt",
                                                          "host.json"]
    assert json.loads((step_dir / "host.json").read_text())["world_size"] == 2


def test_torchrun_world2_replicas_and_shards(runs):
    a, b = final_shards(runs[0] / "first")
    # the agent is replicated bit for bit; the envs are each rank's own
    assert diff_states(a["agent"], b["agent"]) == []
    assert a["agent"]["step"] > 0
    assert a["env_states"]["body"]["pos"].shape == (4, 3)
    assert not torch.equal(a["env_states"]["body"]["pos"], b["env_states"]["body"]["pos"])
    assert a["buffer"]["size"] == b["buffer"]["size"] == 2 * 16 * 4


def test_resume_at_world2_continues_exactly(runs):
    tmp = runs[0]
    resumed, straight = final_shards(tmp / "resumed"), final_shards(tmp / "straight")
    for r in range(2):
        assert diff_states(resumed[r], straight[r]) == [], r
    first = final_shards(tmp / "first")
    assert diff_states(first[0], straight[0])   # the comparison can fail


def test_resume_at_another_world_size_raises(runs, tmp_path):
    cfg = tiny_cfg(tmp_path, 3 * STEPS_PER_ITER, EVERY_ITERATION)
    with pytest.raises(ValueError, match="written by 2 process"):
        Trainer(cfg, output_dir=tmp_path / "single", resume=runs[0] / "first" / "checkpoints",
                device="cpu")


def test_torchrun_world2_ensemble_and_mesh_devices_rule(tmp_path):
    proc = torchrun(tmp_path, "ens", STEPS_PER_ITER,
                    ["training.algorithm=ensemble", "hardware.mesh_devices=2"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("final: success=") == 1
    log = (tmp_path / "ens" / "training.log").read_text()
    assert "ensemble data parallel: 2 ranks (gloo)" in log
    assert json.loads((tmp_path / "ens" / "final_metrics.json").read_text())["env_steps"] == 128
    assert (tmp_path / "ens" / "ensemble_final.pt").exists()
    refused = torchrun(tmp_path, "one", STEPS_PER_ITER, ["hardware.mesh_devices=1"])
    assert refused.returncode != 0
    assert "mesh_devices=1 asks for a single process" in refused.stderr
