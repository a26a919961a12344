"""tvc_ai_torch stands alone: no JAX, no tvc_ai_tpu, CUDA unless asked otherwise."""

from __future__ import annotations

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import tvc_ai_torch
from tvc_ai_torch.agents import sac
from tvc_ai_torch.agents.replay import ReplayBuffer
from tvc_ai_torch.convert import env_state_from_numpy, sac_state_from_numpy
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.types import EnvParams
from tvc_ai_torch.training import loop

ROOT = Path(__file__).resolve().parent.parent
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(tvc_ai_torch.__path__, "tvc_ai_torch.")
)


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'tvc_ai_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert {"tvc_ai_torch.agents.optim", "tvc_ai_torch.agents.replay", "tvc_ai_torch.agents.sac",
            "tvc_ai_torch.training.loop", "tvc_ai_torch.convert"} <= set(MODULES)


def test_chip_smoke_imports_without_jax():
    code = (
        "import sys, runpy\n"
        "sys.argv = ['chip_smoke.py', '--help']\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "finally:\n"
        "    bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tvc_ai_tpu')]\n"
        "    assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _flax_params(module: torch.nn.Module) -> dict:
    """A module's weights laid out as flax params (numpy, kernels (in, out))."""
    tree: dict = {}
    for name, t in module.state_dict().items():
        *path, kind = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node["kernel" if kind == "weight" else "bias"] = (t.T if kind == "weight" else t).numpy()
    return {"params": tree}


def _numpy_sac_state(cfg: sac.SACConfig) -> dict:
    """A JAX-shaped ``SACState`` (optax's chain states as tuples) built
    without JAX."""
    src = sac.init(10, 2, cfg, device="cpu")

    def chain(m):
        return ((), ({"mu": _flax_params(m), "nu": _flax_params(m), "count": 0}, ()))

    return {
        "actor_params": _flax_params(src.actor), "critic_params": _flax_params(src.critic),
        "target_critic_params": _flax_params(src.target_critic),
        "log_alpha": src.log_alpha.numpy(), "actor_opt": chain(src.actor),
        "critic_opt": chain(src.critic),
        "alpha_opt": ({"mu": src.log_alpha.numpy() * 0, "nu": src.log_alpha.numpy() * 0,
                       "count": 0}, ()),
        "step": 0, "ema_actor_params": None,
    }


ENTRY_POINTS = ["reset", "actor", "env_state_from_numpy", "sac_init", "replay_create",
                "init_carry", "sac_state_from_numpy"]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_points_default_to_cuda(entry):
    """With no device given an entry point asks for CUDA: it raises where
    there is none, and places its tensors on the card where there is one."""
    small = sac.SACConfig((8, 8), buffer_size=64)
    calls = {
        "reset": lambda: rocket_env.reset(EnvParams(), 2)[1],
        "actor": lambda: next(sac.make_actor(10, 2, sac.SACConfig((8, 8))).parameters()),
        "env_state_from_numpy": lambda: env_state_from_numpy(
            rocket_env.reset(EnvParams(), 2, device="cpu")[0]
        ).fuel,
        "sac_init": lambda: sac.init(10, 2, small).log_alpha,
        "replay_create": lambda: ReplayBuffer.create(8, {"obs": torch.zeros(10)}).data["obs"],
        "init_carry": lambda: loop.init_carry(
            EnvParams(), small, loop.TrainLoopConfig(num_envs=4, rollout_steps=1)).obs,
        "sac_state_from_numpy": lambda: sac_state_from_numpy(
            _numpy_sac_state(small), small, 10, 2).log_alpha,
    }
    if torch.cuda.is_available():
        assert calls[entry]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calls[entry]()


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
