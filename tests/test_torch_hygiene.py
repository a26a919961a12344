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
from tvc_ai_torch.convert import env_state_from_numpy
from tvc_ai_torch.env import rocket_env
from tvc_ai_torch.env.types import EnvParams

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
    assert len(MODULES) >= 15


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


@pytest.mark.parametrize("entry", ["reset", "actor", "env_state_from_numpy"])
def test_entry_points_default_to_cuda(entry):
    """With no device given an entry point asks for CUDA: it raises where
    there is none, and places its tensors on the card where there is one."""
    calls = {
        "reset": lambda: rocket_env.reset(EnvParams(), 2)[1],
        "actor": lambda: next(sac.make_actor(10, 2, sac.SACConfig((8, 8))).parameters()),
        "env_state_from_numpy": lambda: env_state_from_numpy(
            rocket_env.reset(EnvParams(), 2, device="cpu")[0]
        ).fuel,
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
