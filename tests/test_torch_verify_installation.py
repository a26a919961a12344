"""The port's installation check (``tvc_ai_torch.verify_installation``): its
exit codes, its device rule, and its lines against the JAX package's
``verify_installation.py``."""

from __future__ import annotations

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import pytest
import torch

from tvc_ai_torch import verify_installation as vi

ROOT = Path(__file__).resolve().parent.parent
LINE = re.compile(r"^\[(ok  |FAIL|opt )\] (optional: .+(?= \()|.+?)(?:: (.*)| \((.*)\))?$")
# the checks the two scripts share
SHARED = ["python >= 3.10", "numpy", "yaml", "gymnasium registration",
          *(f"optional: {feature}" for mod, feature in vi.OPTIONAL_FEATURES
            if mod != "gymnasium")]
REWARD = re.compile(r"^reward=-?\d+\.\d\d$")


def parse(out: str) -> tuple[dict[str, tuple[str, str | None]], list[str]]:
    """({check name: (mark, detail)}, the summary lines after the blank one);
    an optional feature's detail is ``available`` or ``absent``."""
    head, _, tail = out.partition("\n\n")
    lines = {}
    for line in head.splitlines():
        m = LINE.match(line)
        assert m, f"not a check line: {line!r}"
        lines[m.group(2)] = (m.group(1), m.group(3) or m.group(4))
    return lines, tail.strip().splitlines()


def run_port(argv: list[str]) -> tuple[int, str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = vi.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def port_cpu() -> tuple[int, str]:
    return run_port(["--cpu"])


@pytest.fixture(scope="module")
def jax_cpu() -> tuple[int, str]:
    """The JAX package's script, loaded by path, run with ``--cpu``."""
    spec = importlib.util.spec_from_file_location("jax_verify_installation",
                                                  ROOT / "verify_installation.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv, sys.argv = sys.argv, ["verify_installation.py", "--cpu"]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = mod.main()
    finally:
        sys.argv = argv
    return rc, buf.getvalue()


def test_cpu_flag_passes(port_cpu):
    rc, out = port_cpu
    lines, summary = parse(out)
    assert rc == 0, out
    assert summary == ["All required checks passed."]
    assert lines["torch device"][0] == "ok  " and lines["torch device"][1].startswith("cpu")
    assert lines["rocket env step"][0] == "ok  "
    assert not [name for name, (mark, _) in lines.items() if mark == "FAIL"]


def test_k1_line_is_optional_under_cpu(port_cpu):
    lines, _ = parse(port_cpu[1])
    assert lines["K1 build + launch"] == ("opt ", "needs the card")


def test_without_cpu_fails_on_the_torch_device():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; chip_smoke.py [23] runs the check there")
    rc, out = run_port([])
    lines, summary = parse(out)
    assert rc == 1
    assert lines["torch device"][0] == "FAIL" and "no CUDA device" in lines["torch device"][1]
    # K1 is a failure here, never skipped or passed
    assert lines["K1 build + launch"][0] == "FAIL"
    assert summary[0].startswith("FAILED checks: [") and "'torch device'" in summary[0]


def test_k1_check_holds_the_kernel_against_the_plain_integrator(monkeypatch):
    """The card's K1 check around its build: on CPU tensors K1's wrapper
    runs the plain version, so the difference is 0 within the flight bar."""
    from tvc_ai_torch.ops import step_kernel as k1

    monkeypatch.setattr(k1, "build", lambda: (k1.BUILD_DIR / "libtvc_step_x.so", ""))
    detail = vi.k1_check(torch.device("cpu"))
    assert detail == ("built libtvc_step_x.so from csrc/step_kernel.cu; N=64 max |K1 - plain| "
                      "0.000e+00 (atol 2e-05, rtol 0.0002)")


@pytest.mark.parametrize("missing", vi.CORE_DEPENDENCIES)
def test_missing_required_module_fails(missing, monkeypatch):
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == missing else find_spec(name, *a))
    rc, out = run_port(["--cpu"])
    lines, summary = parse(out)
    assert rc == 1
    assert lines[missing] == ("FAIL", "not installed")
    assert summary == [f"FAILED checks: {[missing]}"]


@pytest.mark.parametrize("name", SHARED)
def test_line_equals_the_jax_script(name, port_cpu, jax_cpu):
    """A check both scripts make prints the same line in both."""
    (port, _), (jax, _) = parse(port_cpu[1]), parse(jax_cpu[1])
    assert port[name] == jax[name]


def test_env_line_and_summary_match_the_jax_script(port_cpu, jax_cpu):
    (port, port_summary), (jax, jax_summary) = parse(port_cpu[1]), parse(jax_cpu[1])
    assert jax_cpu[0] == port_cpu[0] == 0
    assert port_summary == jax_summary == ["All required checks passed."]
    for lines in (port, jax):
        mark, detail = lines["rocket env step"]
        assert mark == "ok  " and REWARD.match(detail), detail
