"""The port's performance suite (``tvc_ai_torch.benchmark``) and test runner
(``tvc_ai_torch.run_tests``) against the JAX build's ``tests/benchmark.py``
and ``tests/run_tests.py``: the result keys each function fills, the
convergence rule, the printed lines and the runner's selections."""

from __future__ import annotations

import ast
import functools
import importlib.util
import json
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from tvc_ai_torch import benchmark, run_tests

ROOT = Path(__file__).resolve().parent.parent
REFERENCE = ROOT / "tests" / "benchmark.py"
FUNCTIONS = ("bench_env_steps", "bench_inference", "bench_training", "bench_memory",
             "bench_convergence")
# each function at a size the CPU runs in well under a second
TINY = {
    "bench_env_steps": dict(single_steps=5, num_envs=8, steps=3, calls=2),
    "bench_inference": dict(calls=5, batch=16, batch_calls=2),
    "bench_training": dict(updates=2, batch_size=16),
    "bench_memory": dict(rows=1000),
    "bench_convergence": dict(iterations=4, num_envs=8, rollout_steps=4, updates_per_step=2,
                              hidden_dims=(8, 8), batch_size=8, buffer_size=64,
                              learning_starts=16),
}


def _bind(target: ast.AST, value) -> dict:
    if isinstance(target, ast.Name):
        return {target.id: value}
    return {k: v for t, x in zip(target.elts, value) for k, v in _bind(t, x).items()}


def _key(node: ast.AST, env: dict) -> str:
    if isinstance(node, ast.Constant):
        return node.value
    return "".join(part.value if isinstance(part, ast.Constant) else str(env[part.value.id])
                   for part in node.values)


def _keys(node: ast.AST, env: dict, cond: bool, out: set) -> None:
    """(key, assigned under an ``if``) of every ``results[...] = ...`` below
    ``node``; a ``for`` over a literal is unrolled to expand f-string keys."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, ast.For):
            try:
                values = ast.literal_eval(child.iter)
            except ValueError:
                values = None
            if values is not None:
                for value in values:
                    _keys(child, {**env, **_bind(child.target, value)}, cond, out)
                continue
        if isinstance(child, ast.Assign):
            out |= {(_key(t.slice, env), cond) for t in child.targets
                    if isinstance(t, ast.Subscript) and getattr(t.value, "id", "") == "results"}
        if isinstance(child, ast.AnnAssign) and isinstance(child.value, ast.Dict):
            out |= {(k.value, cond) for k in child.value.keys}
        _keys(child, env, cond or isinstance(child, ast.If), out)


@functools.cache
def reference_keys() -> dict[str, tuple[frozenset, frozenset]]:
    """By function of ``tests/benchmark.py``: (the keys it always assigns,
    those it assigns only under an ``if``)."""
    tree = ast.parse(REFERENCE.read_text())
    found = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef):
            out = set()
            _keys(fn, {}, False, out)
            found[fn.name] = (frozenset(k for k, c in out if not c),
                              frozenset(k for k, c in out if c))
    return found


def test_reference_keys_are_read():
    keys = reference_keys()
    assert keys["bench_inference"][0] == {"inference_per_sec_deterministic",
                                          "inference_per_sec_stochastic",
                                          "inference_per_sec_batched4096"}
    assert keys["bench_memory"][1] == {"hbm_bytes_in_use"}
    assert keys["main"][0] == {"timestamp"}


@pytest.mark.parametrize("name", FUNCTIONS)
def test_function_fills_the_reference_keys(name):
    """Each function fills exactly the keys its namesake assigns (the
    memory keys where psutil imports); the one assigned under an ``if`` (the
    device's bytes in use, which the JAX CPU device does not report) only on
    the card."""
    always, conditional = reference_keys()[name]
    if name == "bench_memory" and importlib.util.find_spec("psutil") is None:
        always = frozenset()   # the reference's rule: no psutil, no memory keys
    results = {}
    getattr(benchmark, name)(results, "cpu", **TINY[name])
    assert set(results) == always
    assert conditional.isdisjoint(results)
    for key, value in results.items():
        if key == "convergence_rewards":
            assert len(value) == TINY[name]["iterations"] and all(map(math.isfinite, value))
        elif key == "convergence_iteration":
            assert 3 <= value <= TINY[name]["iterations"]
        else:
            assert math.isfinite(value) and value > 0, (key, value)


def test_main_writes_the_reference_keys_and_lines(monkeypatch, tmp_path, capsys):
    for name in FUNCTIONS:
        monkeypatch.setattr(benchmark, name,
                            functools.partial(getattr(benchmark, name), **TINY[name]))
    out = tmp_path / "sub" / "results.json"
    assert benchmark.main(["--cpu", "--out", str(out)]) == 0
    results = json.loads(out.read_text())
    always = set().union(*(keys for name, (keys, _) in reference_keys().items()
                           if name != "bench_memory" or importlib.util.find_spec("psutil")))
    assert set(results) == always
    lines = capsys.readouterr().out.splitlines()
    floats = [f"{k}: {v:,.1f}" for k, v in results.items() if isinstance(v, float)]
    assert lines == [f"benchmarking {n}..." for n in
                     ("env", "inference", "training", "memory", "convergence")] + floats + [
        f"results -> {out}"]


def test_default_output_is_in_the_build_directory():
    assert benchmark.DEFAULT_OUT == ROOT / "tvc_ai_torch" / "build" / "benchmark_results.json"


REWARD_LISTS = {
    "rising": [float(10 * (1 - 0.7 ** i)) for i in range(20)],
    "flat": [5.0] * 20,
    "zero_mean": [0.0] * 20,
    "zero_mean_then_flat": [1.0, -1.0, 0.0] + [0.0] * 5 + [2.0] * 12,
    "never_settles": [(-1.0) ** i * (i + 1) for i in range(20)],
    "negative_settling": [-50.0 + 40 * 0.5 ** i for i in range(20)],
    "noisy": list(np.random.default_rng(7).normal(3.0, 0.02, 20)),
}


@pytest.mark.parametrize("name", REWARD_LISTS)
def test_convergence_rule_equals_the_jax_file(name, monkeypatch):
    """``convergence_iteration`` against ``tests/benchmark.py``'s own rule:
    its ``bench_convergence`` runs with the JAX loop replaced by one that
    replays the reward list."""
    from tvc_ai_tpu.training import loop as jax_loop

    rewards = REWARD_LISTS[name]
    spec = importlib.util.spec_from_file_location("reference_benchmark", REFERENCE)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)

    def make_train_iteration(sac_cfg, loop_cfg):
        replay = iter(rewards)
        return lambda carry, params: (carry, {"reward_mean": np.float32(next(replay))})

    monkeypatch.setattr(jax, "jit", lambda fn, **kwargs: fn)
    monkeypatch.setattr(jax_loop, "init_carry", lambda *args, **kwargs: None)
    monkeypatch.setattr(jax_loop, "make_train_iteration", make_train_iteration)
    results = {}
    ref.bench_convergence(results)
    assert results["convergence_rewards"] == [float(np.float32(r)) for r in rewards]
    assert benchmark.convergence_iteration(results["convergence_rewards"]) == results[
        "convergence_iteration"]


@pytest.mark.parametrize("argv, want", [
    (["unit"], [str(ROOT / "tests" / n) for n in run_tests.UNIT]),
    (["integration"], [str(ROOT / "tests" / n) for n in run_tests.INTEGRATION]),
    (["fast"], "port -m"),
    ([], "port -m"),
    (["all"], "port"),
    (["unit", "--cov", "-x"], [str(ROOT / "tests" / n) for n in run_tests.UNIT]
     + ["--cov=tvc_ai_torch", "--cov-report=term-missing", "-x"]),
    (["benchmark"], None),
    (["benchmark", "--cpu"], None),
    (["nope"], 2),
])
def test_run_tests_selections(argv, want, monkeypatch, capsys):
    calls = []
    monkeypatch.setattr(run_tests.subprocess, "call",
                        lambda cmd, cwd=None: calls.append((cmd, cwd)) or 0)
    rc = run_tests.main(argv)
    if want == 2:
        assert rc == 2 and not calls and "unknown selection 'nope'" in capsys.readouterr().out
        return
    assert rc == 0
    (cmd, cwd), = calls
    assert cwd == ROOT
    if want is None:
        assert cmd == [sys.executable, "-m", "tvc_ai_torch.benchmark", *argv[1:]]
        return
    assert cmd[:4] == [sys.executable, "-m", "pytest", "-q"]
    port = sorted(str(p) for p in (ROOT / "tests").glob("test_torch_*.py"))
    assert __file__ in port
    if isinstance(want, str):
        want = {"port": port, "port -m": [*port, "-m", "not slow"]}[want]
    assert cmd[4:] == want
    assert all(Path(a).exists() for a in cmd[4:] if a.endswith(".py"))
