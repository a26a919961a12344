"""The port's test runner with named selections.

    python -m tvc_ai_torch.run_tests unit          # physics, quaternion, env, SAC, models
    python -m tvc_ai_torch.run_tests integration   # the end-to-end files
    python -m tvc_ai_torch.run_tests fast          # -m "not slow"
    python -m tvc_ai_torch.run_tests benchmark     # python -m tvc_ai_torch.benchmark
    python -m tvc_ai_torch.run_tests all           # every tests/test_torch_*.py
    ... add --cov for coverage (needs pytest-cov)

The counterpart of ``tests/run_tests.py`` over the port's tests
(``tests/test_torch_*.py``), run from the repository's root. The port's
tests carry no ``integration`` marker, so ``integration`` names its
end-to-end files. Arguments after the selection go to pytest (to the
suite for ``benchmark``, e.g. ``--cpu``). An unknown selection exits 2.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
UNIT = ("test_torch_physics.py", "test_torch_quaternion_extras.py", "test_torch_env.py",
        "test_torch_sac.py", "test_torch_models.py")
INTEGRATION = ("test_torch_slice.py", "test_torch_train_loop.py", "test_torch_trainer.py")
NAMES = ("unit", "integration", "fast", "all")


def pytest_args(selection: str) -> list[str]:
    """The test files (and marker expression) of one of ``NAMES``."""
    port = sorted(str(p) for p in TESTS.glob("test_torch_*.py"))
    return {
        "unit": [str(TESTS / name) for name in UNIT],
        "integration": [str(TESTS / name) for name in INTEGRATION],
        "fast": [*port, "-m", "not slow"],
        "all": port,
    }[selection]


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    selection = args[0] if args and not args[0].startswith("-") else "fast"
    extra = args[1:] if args and not args[0].startswith("-") else args
    if selection == "benchmark":
        return subprocess.call([sys.executable, "-m", "tvc_ai_torch.benchmark", *extra],
                               cwd=ROOT)
    if selection not in NAMES:
        print(f"unknown selection {selection!r}; choose from {[*NAMES, 'benchmark']}")
        return 2
    cmd = [sys.executable, "-m", "pytest", "-q", *pytest_args(selection)]
    if "--cov" in extra:
        extra = [a for a in extra if a != "--cov"]
        cmd += ["--cov=tvc_ai_torch", "--cov-report=term-missing"]
    cmd += extra
    print(" ".join(cmd))
    return subprocess.call(cmd, cwd=ROOT)


if __name__ == "__main__":
    raise SystemExit(main())
