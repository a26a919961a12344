"""The console-script entry points of tvc_ai_torch (``tvc_ai_torch.cli``).

Each of ``tvc-torch-train``, ``tvc-torch-evaluate`` and ``tvc-torch-export``
reaches the port's own parser with the process's arguments (``--help``
exits 0 and prints the port's usage, with no ``scripts/`` directory
involved); ``pyproject.toml`` names the three and keeps the JAX package's
three.
"""

from __future__ import annotations

import contextlib
import io
import sys
import tomllib
from pathlib import Path

import pytest

from tvc_ai_torch import cli

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = {
    "tvc-torch-train": ("train_main", "TVC trainer (PyTorch/CUDA port)"),
    "tvc-torch-evaluate": ("evaluate_main", "TVC evaluation (PyTorch/CUDA port)"),
    "tvc-torch-export": ("export_main", "python -m tvc_ai_torch.export"),
}


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_console_script_reaches_the_ports_parser(script, monkeypatch):
    name, marker = SCRIPTS[script]
    monkeypatch.setattr(sys, "argv", [script, "--help"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_info:
        getattr(cli, name)()
    assert exit_info.value.code == 0
    assert marker in out.getvalue()


def test_pyproject_names_the_console_scripts():
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts == {
        "tvc-train": "tvc_ai_tpu.cli:train_main",
        "tvc-evaluate": "tvc_ai_tpu.cli:evaluate_main",
        "tvc-export": "tvc_ai_tpu.cli:export_main",
        **{script: f"tvc_ai_torch.cli:{name}" for script, (name, _) in SCRIPTS.items()},
    }
    for _, (name, _) in SCRIPTS.items():
        assert callable(getattr(cli, name))
