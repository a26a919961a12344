"""The JAX trainer's sharded orbax checkpoints resumed by the port (CPU).

A JAX ``Trainer`` at ``hardware.mesh_devices=2`` (two of the conftest's
virtual CPU devices) writes a checkpoint whose env rows, replay rows and
episode rings are laid out per device (``tvc_ai_tpu/parallel/mesh.py``:
``carry_specs``, ``make_sharded_train``). The narrow run here: 64 envs,
32×32, a 1024-row replay (two 512-row shards), 20 steps with episodes of 2
steps, so each device's replay has wrapped (``ptr`` 128, ``size`` 512) and
each device's 256-slot ring has overflowed. The bars:

- world 1 (``mesh.shard_jax_carry``): the replay equal to an explicit
  permutation of orbax's own restore of the global arrays, bit for bit, with
  ``ptr`` and ``size`` doubled; the resumed trainer's drained episodes equal
  to the newest 256 of the JAX mesh-2 trainer's drain of the same
  checkpoint; one iteration and its eval round;
- world 2, two ``torchrun`` ranks on gloo: rank r's resumed carry equal to
  ``convert.train_carry_from_numpy`` of shard r of orbax's restore onto the
  JAX mesh, leaf for leaf, bit for bit; one iteration on each rank;
- refusals: a world the env batch does not divide over, a ring or a replay
  that does not lay out, each a ``ValueError`` naming the counts;
- ``load_agent_state`` of the mesh-2 step within 1e-6 of the JAX package's;
- the committed fixture (``tests/fixtures/jax_orbax_mesh2/``: the default
  config with ``training.rollout_steps=2`` at ``hardware.mesh_devices=2``,
  which ``chip_smoke.py`` [22] resumes on the card): every leaf's SHA-256,
  globally and for each rank's part at world 2, against ``manifest.json``.
  Rewrite it with

    XLA_FLAGS=--xla_force_host_platform_device_count=2 PYTHONPATH=. \\
        python tests/test_torch_orbax_mesh.py
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_orbax import (
    ACT,
    BAR,
    NARROW,
    OBS,
    ROWS,
    checksums,
    jax_agent_outputs,
    port_agent_outputs,
    restore_numpy,
    run_jax_trainer,
    state_dict_tree,
)
from test_torch_parity_utils import shard_of
from tvc_ai_torch.config import load_config as t_load_config
from tvc_ai_torch.config.build import build_loop_config, build_sac_config
from tvc_ai_torch.convert import train_carry_from_numpy
from tvc_ai_torch.eval.evaluate import load_agent_state
from tvc_ai_torch.parallel import mesh
from tvc_ai_torch.training import loop as t_loop
from tvc_ai_torch.training.trainer import Trainer
from tvc_ai_torch.utils import orbax_read
from tvc_ai_torch.utils.checkpoint import diff_states
from tvc_ai_tpu.config.build import build_sac_config as j_build_sac_config
from tvc_ai_tpu.training import loop as j_loop
from tvc_ai_tpu.utils.checkpoint import CheckpointManager, abstract_like

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "jax_orbax_mesh2"
N, RING, WRITE_STEPS, RESUME_STEPS = 64, 256, 20, 2
MESH = [*[o for o in NARROW if not o.startswith(("hardware.", "training.rollout_steps"))],
        f"training.rollout_steps={WRITE_STEPS}", "env.max_episode_steps=2"]
FIXTURE_OVERRIDES = ["training.rollout_steps=2", "logging.tensorboard=false",
                     "hardware.mesh_devices=2"]
# one torchrun rank: resume, save the carry as resumed, train one iteration
RANK_SCRIPT = """
import json, sys
from pathlib import Path
import torch
from tvc_ai_torch.config import load_config
from tvc_ai_torch.training.trainer import Trainer
from tvc_ai_torch.utils.checkpoint import state_of

out, root, overrides = Path(sys.argv[1]), sys.argv[2], sys.argv[3:]
tr = Trainer(load_config(None, overrides), output_dir=out / "run", resume=root, device="cpu")
torch.save(state_of(tr.carry), out / f"carry{tr.rank}.pt")
steps = tr.env_steps
result = tr.train()
(out / f"result{tr.rank}.json").write_text(json.dumps(
    {"world": tr.world, "resumed_env_steps": steps, "env_steps": result["env_steps"],
     "iterations": result["iterations"], "eval_success_rate": result["eval_success_rate"]}))
"""


def port_overrides(out, world: int, total: int) -> list[str]:
    return [f"globals.output_dir={out}", *MESH, f"hardware.mesh_devices={world}",
            f"training.rollout_steps={RESUME_STEPS}", f"training.total_timesteps={total}"]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """A narrow JAX mesh-2 ``Trainer`` checkpoint and the trainer that wrote it."""
    out = tmp_path_factory.mktemp("jax_mesh2")
    tr, cfg = run_jax_trainer(out, [*MESH, "hardware.mesh_devices=2"])
    assert tr.mesh is not None and tr.mesh.devices.size == 2
    root = out / "checkpoints"
    disk = orbax_read.OrbaxCheckpoints(root).read(tr.env_steps)
    return types.SimpleNamespace(trainer=tr, cfg=cfg, root=root, step=tr.env_steps, out=out,
                                 disk=disk)


def global_permutation(n: int, rows: int, envs: int) -> np.ndarray:
    """Source row of each row of the one-device layout: global row g is step
    block g // N, env g % N, which device d = env // (N/n) wrote at its row
    d·cap + block·N/n + env % (N/n)."""
    g = np.arange(rows)
    block, env = g // envs, g % envs
    local = envs // n
    return env // local * (rows // n) + block * local + env % local


def test_world1_relays_the_replay(mesh_run):
    disk = mesh_run.disk
    assert mesh.jax_carry_shards(disk) == 2
    step_dir = mesh_run.root / str(mesh_run.step)
    want = restore_numpy(step_dir, mesh_run.trainer.carry)
    ptr, size = int(want["buffer"]["ptr"]), int(want["buffer"]["size"])
    assert (ptr, size) == (128, 512)   # each 512-row shard has wrapped
    relaid = mesh.shard_jax_carry(disk, 2, 1, 0, N, RING)
    rows = want["buffer"]["data"]["obs"].shape[0]
    perm = global_permutation(2, rows, N)
    assert sorted(perm.tolist()) == list(range(rows))
    for k, v in want["buffer"]["data"].items():
        got = relaid["buffer"]["data"][k]
        assert got.dtype == v.dtype and got.tobytes() == v[perm].tobytes(), k
    assert (int(relaid["buffer"]["ptr"]), int(relaid["buffer"]["size"])) == (2 * ptr, 2 * size)
    for name in mesh.JAX_ENV_LEAVES:   # one device's env order is the global order
        assert checksums(relaid[name]) == checksums(want[name]), name
    assert relaid["ep_ring_seq"].shape == (RING,) and relaid["ep_ring_ptr"].shape == (1,)
    assert mesh.shard_jax_carry(disk, 1, 1, 0, N, RING) is disk


def test_world1_resume_drains_as_the_jax_mesh(mesh_run, tmp_path):
    j_eps, j_last = j_loop.drain_episodes(mesh_run.trainer.carry, -1)
    assert len(j_eps) > RING   # two overflowed shard rings: more than one ring holds
    cfg = t_load_config(None, port_overrides(tmp_path, 1, mesh_run.step + N * RESUME_STEPS))
    tr = Trainer(cfg, output_dir=tmp_path / "run", resume=mesh_run.root, device="cpu")
    want = train_carry_from_numpy(mesh.shard_jax_carry(mesh_run.disk, 2, 1, 0, N, RING),
                                  tr.sac_cfg, tr.loop_cfg, device="cpu", seed=cfg.globals.seed)
    assert diff_states(tr.carry, want) == []
    t_eps, t_last = t_loop.drain_episodes(tr.carry, -1)
    assert t_last == j_last and t_eps == j_eps[-RING:]
    assert int(tr.carry.ep_ring_ptr[0]) == 0   # a full ring: the oldest slot is next
    assert tr.env_steps == mesh_run.step and tr.iteration == 1
    result = tr.train()
    assert result["iterations"] == 2 and result["env_steps"] == mesh_run.step + N * RESUME_STEPS
    assert np.isfinite(result["eval_success_rate"])


def test_world2_ranks_equal_their_shards(mesh_run, tmp_path):
    script = tmp_path / "resume_rank.py"
    script.write_text(RANK_SCRIPT)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2",
           str(script), str(tmp_path), str(mesh_run.root),
           *port_overrides(tmp_path, 2, mesh_run.step + N * RESUME_STEPS)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    restored, _ = CheckpointManager(mesh_run.root).restore(
        abstract_like(mesh_run.trainer.carry), mesh_run.step)
    cfg = t_load_config(None, port_overrides(tmp_path, 2, 0))
    sac_cfg, loop_cfg = build_sac_config(cfg), build_loop_config(cfg)
    for r in range(2):
        shard = state_dict_tree(shard_of(restored, r))
        assert shard["obs"].shape[0] == N // 2 and shard["ep_ring_ptr"].shape == (1,)
        want = train_carry_from_numpy(shard, sac_cfg, loop_cfg, device="cpu",
                                      seed=mesh.rank_seed(cfg.globals.seed, r))
        got = torch.load(tmp_path / f"carry{r}.pt", weights_only=True)
        assert diff_states(got, want) == [], r
        result = json.loads((tmp_path / f"result{r}.json").read_text())
        assert result["world"] == 2 and result["resumed_env_steps"] == mesh_run.step
        assert result["iterations"] == 2
        assert result["env_steps"] == mesh_run.step + N * RESUME_STEPS
        assert np.isfinite(result["eval_success_rate"])


@pytest.mark.parametrize("case", ["world", "ring", "replay"])
def test_layouts_that_do_not_divide_are_refused(mesh_run, case):
    disk = dict(mesh_run.disk)
    world, ring = 2, RING
    if case == "world":
        world = 3
        match = "2 device.*world 3.*64 envs"
    elif case == "ring":
        ring = 128
        match = "2 device.*world 2.*512 entries, not 2 x 128"
    else:
        disk["buffer"] = dict(disk["buffer"], ptr=np.int32(5))
        match = "2 device.*world 2.*1024 rows \\(ptr 5"
    with pytest.raises(ValueError, match=match):
        mesh.shard_jax_carry(disk, 2, world, 0, N, ring)


def test_load_agent_state_of_a_mesh_checkpoint(mesh_run):
    step_dir = mesh_run.root / str(mesh_run.step)
    obs = np.random.default_rng(6).normal(size=(ROWS, OBS)).astype(np.float32)
    want = jax_agent_outputs(step_dir, j_build_sac_config(mesh_run.cfg), obs)
    cfg = t_load_config(None, port_overrides(mesh_run.out, 1, 0))
    got = port_agent_outputs(load_agent_state(step_dir, OBS, ACT, build_sac_config(cfg),
                                              device="cpu"), obs)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **BAR, err_msg=name)


# ------------------------------------------------------------ the fixture
def shard_checksums(tree, manifest: dict) -> list[dict[str, str]]:
    """Each rank's part at world 2 (``mesh.shard_jax_carry``), as checksums."""
    return [checksums(mesh.shard_jax_carry(tree, 2, 2, r, manifest["num_envs"],
                                           manifest["ring_size"])) for r in range(2)]


def write_fixture(directory: Path = FIXTURE) -> None:
    """Write the fixture with the JAX package: a default-config ``Trainer``
    at ``hardware.mesh_devices=2`` after one 2-step iteration, its orbax
    checkpoint and the SHA-256 of every carry leaf, globally (orbax's
    restore) and for each device's shard (the JAX arrays' own shards)."""
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    with tempfile.TemporaryDirectory() as tmp:
        tr, cfg = run_jax_trainer(Path(tmp), FIXTURE_OVERRIDES, directory / "checkpoints")
    assert tr.mesh is not None and tr.mesh.devices.size == 2
    step = tr.env_steps
    restored, _ = CheckpointManager(directory / "checkpoints").restore(abstract_like(tr.carry),
                                                                      step)
    whole = state_dict_tree(jax.tree.map(np.asarray, restored))
    manifest = {
        "step": step, "overrides": FIXTURE_OVERRIDES, "obs_dim": OBS,
        "num_envs": cfg.training.num_envs, "ring_size": int(tr.loop_cfg.episode_ring_size),
        "rollout_steps": cfg.training.rollout_steps, "devices": 2,
        "buffer_rows": int(whole["buffer"]["data"]["obs"].shape[0]),
        "buffer_ptr": int(whole["buffer"]["ptr"]), "buffer_size": int(whole["buffer"]["size"]),
        "leaves": checksums(whole),
        "shards": [checksums(state_dict_tree(shard_of(restored, r))) for r in range(2)],
    }
    (directory / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")


def test_fixture_matches_manifest():
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    carry = orbax_read.OrbaxCheckpoints(FIXTURE / "checkpoints").read(manifest["step"])
    assert checksums(carry) == manifest["leaves"]
    assert mesh.jax_carry_shards(carry) == manifest["devices"] == 2
    assert shard_checksums(carry, manifest) == manifest["shards"]
    assert carry["buffer"]["data"]["obs"].shape[0] == manifest["buffer_rows"]


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    assert len(jax.devices()) >= 2, "set XLA_FLAGS=--xla_force_host_platform_device_count=2"
    write_fixture(Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURE)
