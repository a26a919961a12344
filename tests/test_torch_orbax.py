"""The JAX package's orbax checkpoints read by the port (CPU).

Checkpoints are written at test time by the JAX package's
``utils.checkpoint.CheckpointManager`` (orbax, OCDBT, zarr v2, zstd) and read
through ``tvc_ai_torch.utils.orbax_read`` (``utils.ocdbt`` over
``utils.zstd``). The bars:

- every leaf equal to orbax's own restore, bit for bit: a tree of f32, bf16,
  i32, u32 and bool leaves, 0-d and n-d, with None leaves and optax tuples;
  an array sharded over 2 CPU devices (one chunk per shard); a narrow JAX
  ``Trainer`` checkpoint (64 envs, 32×32);
- the OCDBT listing and values equal to tensorstore's, also for a database
  with interior b-tree nodes, out-of-line values and a version tree;
- zarr arrays with edge chunks and absent chunks (the fill value) equal to
  tensorstore's reading;
- ``load_agent_state`` on a JAX run's manager root and on one step
  directory: deterministic actions and twin Q within 1e-6 of the JAX
  package's ``load_agent_state``; the EMA actor preferred;
- ``Trainer(resume=<orbax dir>)``: the carry equal to
  ``convert.train_carry_from_numpy`` of the JAX-restored carry, exactly, and
  the host fields equal; rank 0 of world 2 takes its half, world 3 is refused;
- the committed fixture (``tests/fixtures/jax_orbax/``, a default-config JAX
  ``Trainer`` checkpoint after one 2-step iteration, which ``chip_smoke.py``
  [21] reads on the card): actions and twin Q against ``expected.npz``, every
  carry leaf's SHA-256 against ``manifest.json``. Rewrite it with

    PYTHONPATH=. python tests/test_torch_orbax.py
"""

from __future__ import annotations

import functools
import hashlib
import json
import shutil
import sys
import tempfile
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_parity_utils import np_tree
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.config import load_config as t_load_config
from tvc_ai_torch.config.build import build_sac_config
from tvc_ai_torch.convert import train_carry_from_numpy
from tvc_ai_torch.eval.evaluate import load_agent_state
from tvc_ai_torch.training.trainer import Trainer
from tvc_ai_torch.utils import ocdbt, orbax_read
from tvc_ai_torch.utils.checkpoint import CheckpointManager as TCheckpointManager
from tvc_ai_torch.utils.checkpoint import diff_states
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.config import load_config as j_load_config
from tvc_ai_tpu.config.build import build_sac_config as j_build_sac_config
from tvc_ai_tpu.eval.evaluate import load_agent_state as j_load_agent_state
from tvc_ai_tpu.training.trainer import Trainer as JTrainer
from tvc_ai_tpu.utils.checkpoint import CheckpointManager, abstract_like

ts = pytest.importorskip("tensorstore")

torch.set_num_threads(1)
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "jax_orbax"
OBS, ACT, ROWS = 10, 2, 64
BAR = dict(atol=1e-6, rtol=0.0)
# the narrow JAX trainer: 64 envs, 32x32, one 2-step iteration
NARROW = ["training.num_envs=64", "training.rollout_steps=2", "training.eval_episodes=2",
          "algorithms.sac.hidden_dims=[32,32]", "algorithms.sac.buffer_size=1024",
          "algorithms.sac.learning_starts=16", "algorithms.sac.batch_size=16",
          "logging.tensorboard=false", "hardware.mesh_devices=1"]
# the fixture: the default config, cut to one 2-step iteration
FIXTURE_OVERRIDES = ["training.rollout_steps=2", "logging.tensorboard=false",
                     "hardware.mesh_devices=1"]


# ---------------------------------------------------------------- writers
def run_jax_trainer(out: Path, overrides: list[str], ckpt_dir: Path | None = None):
    """A JAX ``Trainer`` after one iteration, saved as orbax step
    ``env_steps`` under ``ckpt_dir`` (default: its own ``checkpoints``)."""
    cfg = j_load_config(None, [f"globals.output_dir={out}", *overrides])
    tr = JTrainer(cfg, output_dir=out)
    tr.carry, _ = tr._train_fn(tr.carry, tr.env_params)
    tr.iteration += 1
    mngr = CheckpointManager(ckpt_dir) if ckpt_dir is not None else tr.ckpt
    mngr.save(tr.env_steps, tr.carry, tr._host_state())
    mngr.wait()
    return tr, cfg


def leaf_paths(tree, prefix=()):
    """(key path, leaf) of every non-None leaf of a nested dict / tuple tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaf_paths(v, prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def leaf_bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):   # bfloat16
        return leaf.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(leaf).tobytes()


def checksums(tree) -> dict[str, str]:
    return {".".join(p): hashlib.sha256(leaf_bytes(x)).hexdigest() for p, x in leaf_paths(tree)}


def jax_agent_outputs(step_dir: Path, sac_cfg, obs: np.ndarray) -> dict[str, np.ndarray]:
    """The JAX ``load_agent_state``'s deterministic actions and twin Q."""
    state = j_load_agent_state(step_dir, obs.shape[-1], ACT, sac_cfg)
    actor, critic = j_sac.make_networks(obs.shape[-1], ACT, sac_cfg)
    mean, _ = actor.apply(state.actor_params, obs)
    actions = np.asarray(jnp.tanh(mean))
    q1, q2 = critic.apply(state.critic_params, obs, actions)
    return {"actions": actions, "q1": np.asarray(q1), "q2": np.asarray(q2)}


def port_agent_outputs(state: t_sac.SACState, obs: np.ndarray) -> dict[str, np.ndarray]:
    dev = state.log_alpha.device
    x = torch.from_numpy(obs).to(dev)
    with torch.no_grad():
        actions = t_sac.select_action(state.actor, x, deterministic=True)
        q1, q2 = state.critic(x, actions)
    return {"actions": actions.cpu().numpy(), "q1": q1.cpu().numpy(), "q2": q2.cpu().numpy()}


def write_fixture(directory: Path = FIXTURE) -> None:
    """Write the fixture with the JAX package: a default-config ``Trainer``
    after one 2-step iteration (4096 envs, 256×256, the 999,424-row ring),
    its orbax checkpoint, the JAX ``load_agent_state``'s outputs on 64
    seeded observations and a SHA-256 of every carry leaf."""
    shutil.rmtree(directory, ignore_errors=True)
    directory.mkdir(parents=True)
    with tempfile.TemporaryDirectory() as tmp:
        tr, cfg = run_jax_trainer(Path(tmp), FIXTURE_OVERRIDES, directory / "checkpoints")
    step = tr.env_steps
    step_dir = directory / "checkpoints" / str(step)
    sac_cfg = j_build_sac_config(cfg)
    obs = np.random.default_rng(0).normal(size=(ROWS, OBS)).astype(np.float32)
    expected = {"obs": obs, **jax_agent_outputs(step_dir, sac_cfg, obs)}
    np.savez(directory / "expected.npz", **expected)
    carry = jax.tree.map(np.asarray, CheckpointManager(directory / "checkpoints").restore(
        abstract_like(tr.carry), step)[0])
    manifest = {
        "step": step, "overrides": FIXTURE_OVERRIDES, "obs_dim": OBS,
        "hidden_dims": list(sac_cfg.hidden_dims), "num_envs": cfg.training.num_envs,
        "rollout_steps": cfg.training.rollout_steps,
        "buffer_rows": int(carry.buffer.data["obs"].shape[0]),
        "buffer_size": int(carry.buffer.size),
        "leaves": checksums(state_dict_tree(carry)),
    }
    (directory / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")


def state_dict_tree(tree):
    """A JAX tree in the nesting orbax stores it: flax's state dict (dicts
    of fields) with its "0".."n-1" dicts as tuples and empty nodes (optax's
    ``EmptyState``) as None."""
    from flax import serialization

    def walk(x):
        if not isinstance(x, dict):
            return x
        if not x:
            return None
        if set(x) == {str(i) for i in range(len(x))}:
            return tuple(walk(x[str(i)]) for i in range(len(x)))
        return {k: walk(v) for k, v in x.items()}

    return walk(serialization.to_state_dict(tree))


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """A narrow JAX ``Trainer`` checkpoint and the trainer that wrote it."""
    out = tmp_path_factory.mktemp("jax_run")
    tr, cfg = run_jax_trainer(out, NARROW)
    return types.SimpleNamespace(trainer=tr, cfg=cfg, root=out / "checkpoints",
                                 step=tr.env_steps, out=out)


def restore_numpy(step_dir: Path, like):
    """orbax's own restore of ``<step>/carry`` into the structure of
    ``like``, as ``state_dict_tree`` of numpy leaves."""
    import orbax.checkpoint as ocp

    restored = ocp.StandardCheckpointer().restore(step_dir / "carry", abstract_like(like))
    return state_dict_tree(jax.tree.map(np.asarray, restored))


def assert_leaves_equal(got, want):
    """Same tree (tuples for sequences, None kept) and bit-equal leaves."""
    if want is None:
        assert got is None
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            assert_leaves_equal(got[k], want[k])
        return
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for a, b in zip(got, want):
            assert_leaves_equal(a, b)
        return
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert got.view(torch.int16).numpy().tobytes() == want.view(np.int16).tobytes()
        return
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def mixed_tree():
    rng = np.random.default_rng(3)
    params = {"w": jnp.asarray(rng.normal(size=(7, 5)).astype(np.float32)),
              "b": jnp.asarray(rng.normal(size=5).astype(np.float32))}
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    return {
        "f32": jnp.asarray(rng.normal(size=(3, 4, 2)).astype(np.float32)),
        "f32_0d": jnp.float32(2.5),
        "bf16": jnp.asarray(rng.normal(size=(6, 3)), dtype=jnp.bfloat16),
        "bf16_0d": jnp.asarray(1.75, dtype=jnp.bfloat16),
        "i32": jnp.asarray(rng.integers(-9, 9, size=(4, 3)).astype(np.int32)),
        "i32_0d": jnp.int32(-7),
        "u32": jnp.asarray(rng.integers(0, 2**32, size=(5,), dtype=np.uint32)),
        "key": jax.random.PRNGKey(11),
        "flags": jnp.asarray(rng.random(9) < 0.5),
        "ring": jnp.zeros((70_000, 6), jnp.float32).at[:10].set(1.5),
        "absent": None,
        "opt": opt.init(params),
        "nested": {"pair": (jnp.ones(3), None), "params": params},
    }


# ------------------------------------------------------------ orbax trees
def test_tree_leaves_equal_orbax_restore(tmp_path):
    tree = mixed_tree()
    mngr = CheckpointManager(tmp_path / "ck")
    mngr.save(5, tree, {"iteration": 2, "curriculum": {"stage": 1}})
    mngr.wait()
    got = orbax_read.OrbaxCheckpoints(tmp_path / "ck").read(5)
    assert_leaves_equal(got, restore_numpy(tmp_path / "ck" / "5", tree))
    assert orbax_read.OrbaxCheckpoints(tmp_path / "ck").host(5) == {
        "iteration": 2, "curriculum": {"stage": 1}}
    assert got["opt"][0] is None and set(got["opt"][1][0]) == {"count", "mu", "nu"}


def test_prefix_decodes_only_its_subtree(tmp_path, monkeypatch):
    tree = mixed_tree()
    mngr = CheckpointManager(tmp_path / "ck")
    mngr.save(5, tree)
    mngr.wait()
    decoded, decompress = [], orbax_read.zstd.decompress

    def counting(data):
        decoded.append(len(data))
        return decompress(data)

    monkeypatch.setattr(orbax_read, "zstd", types.SimpleNamespace(decompress=counting))
    sub = orbax_read.OrbaxCheckpoints(tmp_path / "ck").read(5, prefix=("nested",))
    assert_leaves_equal(sub, restore_numpy(tmp_path / "ck" / "5", tree)["nested"])
    assert len(decoded) == 3   # pair.0, params.w, params.b: never the ring's chunk


def test_sharded_array_reads_its_chunks(tmp_path):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devices = jax.devices()[:2]
    assert len(devices) == 2
    rng = np.random.default_rng(5)
    mesh = Mesh(np.array(devices), ("d",))
    tree = {"rows": jax.device_put(jnp.asarray(rng.normal(size=(64, 30)).astype(np.float32)),
                                   NamedSharding(mesh, P("d"))),
            "cols": jax.device_put(jnp.asarray(rng.integers(0, 9, (6, 8)).astype(np.int32)),
                                   NamedSharding(mesh, P(None, "d"))),
            "replicated": jax.device_put(jnp.arange(5.0), NamedSharding(mesh, P()))}
    mngr = CheckpointManager(tmp_path / "ck")
    mngr.save(1, tree)
    mngr.wait()
    kv = ocdbt.OcdbtReader(tmp_path / "ck" / "1" / "carry")
    assert kv.list("rows/") == [b"rows/.zarray", b"rows/0.0", b"rows/1.0"]
    assert kv.list("cols/") == [b"cols/.zarray", b"cols/0.0", b"cols/0.1"]
    got = orbax_read.OrbaxCheckpoints(tmp_path / "ck").read(1)
    assert_leaves_equal(got, jax.tree.map(np.asarray, tree))


def ocdbt_store(path: Path, **config):
    """tensorstore's OCDBT store at ``path`` (``config``: tensorstore's OCDBT
    configuration for a new database)."""
    spec = ts.KvStore.Spec(f"file://{path}/|ocdbt:").to_json()
    return ts.KvStore.open({**spec, "config": config} if config else spec).result()


def test_zarr_edge_and_absent_chunks(tmp_path):
    """zarr v2 arrays on OCDBT whose edge chunks overrun the shape and most of
    whose chunks are absent (the fill value), read against tensorstore."""
    zstandard = pytest.importorskip("zstandard")
    kv_write = ocdbt_store(tmp_path / "db")
    arrays = {"f": ("<f4", 1.5), "i": ("<i4", -3), "n": ("<f4", "NaN"), "z": ("<u4", None)}
    rng = np.random.default_rng(7)
    for name, (dtype, fill) in arrays.items():
        meta = {"zarr_format": 2, "shape": [10, 7], "chunks": [4, 3], "dtype": dtype,
                "fill_value": fill, "order": "C", "filters": None,
                "compressor": {"id": "zstd", "level": 3}, "dimension_separator": "."}
        kv_write.write(f"{name}/.zarray", json.dumps(meta).encode()).result()
        for index in ((0, 0), (1, 1), (2, 2)):    # (2, 2) overruns both edges
            chunk = rng.integers(0, 50, (4, 3)).astype(np.dtype(dtype))
            kv_write.write(f"{name}/{index[0]}.{index[1]}",
                           zstandard.ZstdCompressor(level=3).compress(chunk.tobytes())).result()
    kv = ocdbt.OcdbtReader(tmp_path / "db")
    for name in arrays:
        want = ts.open(f"file://{tmp_path}/db/|ocdbt:{name}/|zarr2:").result().read().result()
        got = orbax_read.read_array(kv, name)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        assert len(kv.list(f"{name}/")) == 4      # 3 of the 9 chunks, and .zarray


# ------------------------------------------------------------ OCDBT
def many_versions_db(path: Path) -> Path:
    """A database of 40 commits with 300-byte nodes (interior nodes), 50-byte
    inline values (the rest out of line) and a version tree of arity 4."""
    kv = ocdbt_store(path, max_decoded_node_bytes=300, max_inline_value_bytes=50,
                     version_tree_arity_log2=2)
    rng = np.random.default_rng(1)
    for i in range(40):
        value = bytes(rng.integers(0, 256, size=int(rng.integers(1, 120)), dtype=np.uint8))
        kv.write(f"prefix/common/key{i:03d}".encode(), value).result()
    kv.write(b"prefix/common/key005", b"rewritten").result()
    kv.delete_range(ts.KvStore.KeyRange(b"prefix/common/key030", b"prefix/common/key033")
                    ).result()
    return path


@pytest.mark.parametrize("which", ["checkpoint", "process_0", "versioned"])
def test_ocdbt_listing_equals_tensorstore(which, jax_run, tmp_path):
    carry = jax_run.root / str(jax_run.step) / "carry"
    directory = {"checkpoint": carry, "process_0": carry / "ocdbt.process_0",
                 "versioned": tmp_path / "db"}[which]
    if which == "versioned":
        many_versions_db(directory)
    store = ocdbt_store(directory)
    want = sorted(store.list().result())
    kv = ocdbt.OcdbtReader(directory)
    assert kv.list() == want
    for key in want:
        assert kv.read(key) == store.read(key).result().value, key
    assert kv.list(want[3][:6]) == [k for k in want if k.startswith(want[3][:6])]


def _reframe(raw: bytes, version: int) -> bytes:
    """``raw`` (a manifest) with another format version, its CRC redone."""
    out = bytearray(raw)
    out[12] = version
    out[-4:] = ocdbt.crc32c(bytes(out[:-4])).to_bytes(4, "little")
    return bytes(out)


def test_ocdbt_refuses_bad_files(jax_run, tmp_path):
    carry = tmp_path / "carry"
    shutil.copytree(jax_run.root / str(jax_run.step) / "carry", carry)
    manifest = carry / ocdbt.MANIFEST
    raw = manifest.read_bytes()
    manifest.write_bytes(_reframe(raw, 1))
    with pytest.raises(ValueError, match="format version 1"):
        ocdbt.OcdbtReader(carry)
    manifest.write_bytes(raw[:-1] + bytes([raw[-1] ^ 1]))
    with pytest.raises(ValueError, match="checksum"):
        ocdbt.OcdbtReader(carry)
    manifest.write_bytes(raw)
    kv = ocdbt.OcdbtReader(carry)
    key = b"buffer.data.obs/0.0"
    path, offset, length = kv._entries[key]     # a value stored out of line
    data = carry / path
    data.write_bytes(data.read_bytes()[:offset + length - 1])
    with pytest.raises(ValueError, match="holds"):
        kv.read(key)
    data.unlink()
    with pytest.raises(ValueError, match="unreadable"):
        kv.read(key)


def test_zarr3_and_missing_items_refused(jax_run, tmp_path):
    step_dir = tmp_path / "ck" / str(jax_run.step)
    shutil.copytree(jax_run.root / str(jax_run.step), step_dir)
    meta_path = step_dir / "carry" / "_METADATA"
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps({**meta, "use_zarr3": True}))
    with pytest.raises(ValueError, match="use_zarr3"):
        orbax_read.OrbaxCheckpoints(tmp_path / "ck").read(jax_run.step)
    meta_path.write_text(json.dumps({**meta, "use_ocdbt": False}))
    with pytest.raises(ValueError, match="use_ocdbt"):
        orbax_read.OrbaxCheckpoints(tmp_path / "ck").read(jax_run.step)


# ------------------------------------------------------------ the JAX trainer
def test_trainer_checkpoint_equals_orbax_restore(jax_run):
    got = orbax_read.OrbaxCheckpoints(jax_run.root).read(jax_run.step)
    want = restore_numpy(jax_run.root / str(jax_run.step), jax_run.trainer.carry)
    assert_leaves_equal(got, want)
    assert orbax_read.OrbaxCheckpoints(jax_run.root).host(jax_run.step) == json.loads(
        json.dumps(jax_run.trainer._host_state()))


def narrow_sac_cfg(jax_run):
    return build_sac_config(t_load_config(None, [f"globals.output_dir={jax_run.out}", *NARROW]))


@pytest.mark.parametrize("where", ["root", "step"])
def test_load_agent_state_matches_jax(where, jax_run):
    path = jax_run.root if where == "root" else jax_run.root / str(jax_run.step)
    sac_cfg = narrow_sac_cfg(jax_run)
    obs = np.random.default_rng(2).normal(size=(ROWS, OBS)).astype(np.float32)
    want = jax_agent_outputs(jax_run.root / str(jax_run.step),
                             j_build_sac_config(jax_run.cfg), obs)
    got = port_agent_outputs(load_agent_state(path, OBS, ACT, sac_cfg, device="cpu"), obs)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **BAR, err_msg=name)
    mngr, step = TCheckpointManager.locate(path)
    assert isinstance(mngr, orbax_read.OrbaxCheckpoints) and step == jax_run.step


def test_load_agent_state_prefers_the_ema_actor(tmp_path):
    cfg = j_sac.SACConfig(hidden_dims=(16, 16), ema_decay=0.99)
    state = j_sac.init(jax.random.PRNGKey(3), OBS, ACT, cfg)
    state = state.replace(ema_actor_params=jax.tree.map(lambda x: x + 0.25,
                                                        state.actor_params))
    mngr = CheckpointManager(tmp_path / "ck")
    mngr.save(64, {"agent": state})
    mngr.wait()
    obs = np.random.default_rng(4).normal(size=(ROWS, OBS)).astype(np.float32)
    want = jax_agent_outputs(tmp_path / "ck" / "64", cfg, obs)
    got = port_agent_outputs(load_agent_state(
        tmp_path / "ck", OBS, ACT, t_sac.SACConfig(hidden_dims=(16, 16), ema_decay=0.99),
        device="cpu"), obs)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], **BAR, err_msg=name)
    mean, _ = j_sac.make_networks(OBS, ACT, cfg)[0].apply(state.actor_params, obs)
    assert np.abs(np.tanh(np.asarray(mean)) - got["actions"]).max() > 1e-3


@pytest.mark.parametrize("where", ["root", "step"])
def test_trainer_resumes_a_jax_checkpoint(where, jax_run, tmp_path):
    path = jax_run.root if where == "root" else jax_run.root / str(jax_run.step)
    cfg = t_load_config(None, [f"globals.output_dir={tmp_path}", *NARROW])
    tr = Trainer(cfg, output_dir=tmp_path / "run", resume=path, device="cpu")
    restored, _ = CheckpointManager(jax_run.root).restore(abstract_like(jax_run.trainer.carry),
                                                          jax_run.step)
    want = train_carry_from_numpy(np_tree(restored), tr.sac_cfg, tr.loop_cfg, device="cpu",
                                  seed=cfg.globals.seed)
    assert diff_states(tr.carry, want) == []
    host = jax_run.trainer._host_state()
    assert tr.iteration == host["iteration"] == 1
    assert tr.curriculum.state_dict() == json.loads(json.dumps(host["curriculum"]))
    assert tr.stability.state_dict() == json.loads(json.dumps(host["stability"]))
    assert (tr._last_episodes, tr._last_successes, tr._last_ep_seq) == (
        host["last_episodes"], host["last_successes"], host["last_ep_seq"])
    assert tr.env_steps == jax_run.step
    assert torch.equal(tr.generator.get_state(),
                       torch.Generator().manual_seed(cfg.globals.seed).get_state())
    # rank 0 of two: the first half of the envs and of every step block
    tr.world = 2
    tr._resume(path)
    half = cfg.training.num_envs // 2
    assert torch.equal(tr.carry.obs, want.obs[:half])
    blocks = want.buffer.capacity // cfg.training.num_envs
    assert torch.equal(tr.carry.buffer.data["obs"], want.buffer.data["obs"].reshape(
        blocks, cfg.training.num_envs, -1)[:, :half].reshape(blocks * half, -1))
    assert (tr.carry.buffer.ptr, tr.carry.buffer.size) == (want.buffer.ptr // 2,
                                                           want.buffer.size // 2)
    tr.world = 3
    with pytest.raises(ValueError, match="1 device.*world 3"):
        tr._resume(path)


def test_trainer_resume_keeps_fields_the_checkpoint_lacks(jax_run, tmp_path):
    cfg = t_load_config(None, [f"globals.output_dir={tmp_path}", *NARROW])
    tr = Trainer(cfg, output_dir=tmp_path / "run", device="cpu")
    fresh = tr.carry
    disk = orbax_read.OrbaxCheckpoints(jax_run.root).read(jax_run.step)
    del disk["ep_ring_seq"]
    disk["env_states"] = {k: v for k, v in disk["env_states"].items() if k != "prev_imu"}
    carry = tr._carry_from_orbax(disk)
    assert carry.ep_ring_seq is fresh.ep_ring_seq
    assert carry.buffer.size == int(disk["buffer"]["size"]) > 0
    disk.pop("agent")
    with pytest.raises(ValueError, match="agent"):
        tr._carry_from_orbax(disk)


# ------------------------------------------------------------ the fixture
@functools.cache
def fixture() -> tuple[dict, dict]:
    with np.load(FIXTURE / "expected.npz") as npz:
        expected = dict(npz)
    return json.loads((FIXTURE / "manifest.json").read_text()), expected


def test_fixture_matches_expected():
    manifest, expected = fixture()
    root = FIXTURE / "checkpoints"
    cfg = t_load_config(None, manifest["overrides"])
    state = load_agent_state(root / str(manifest["step"]), manifest["obs_dim"], ACT,
                             build_sac_config(cfg), device="cpu")
    got = port_agent_outputs(state, expected["obs"])
    for name in ("actions", "q1", "q2"):
        np.testing.assert_allclose(got[name], expected[name], **BAR, err_msg=name)
    carry = orbax_read.OrbaxCheckpoints(root).read(manifest["step"])
    assert checksums(carry) == manifest["leaves"]
    assert carry["buffer"]["data"]["obs"].shape[0] == manifest["buffer_rows"]


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_fixture(Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURE)
