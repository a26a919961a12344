"""The single-env research diagnostics of tvc_ai_torch against the reference's
scripts (CPU): ``inspect_policy``, ``diagnose_cg``, ``lqr_balance`` and
``scripted_controller``.

Each reference script is loaded from ``scripts/`` and run through its
``main`` with ``sys.argv`` patched (the script itself unchanged); the port's
counterpart runs its factored function on the same inputs: the same actor
weights (a flax ``SACState`` written in the reference's msgpack form and
carried across with ``convert`` into a ``student.pt``), the same replayed
reset draws, and for the LQR probe the same design (the port's
``design_lqr`` of ``EnvParams()``, whose parity ``tests/test_torch_demos.py``
holds; both sides are handed it so the test holds the probe, not a second
design). The printed lines must agree: the same text, integers (steps, runs,
counts) equal, every other number within the env bars (obs 5e-5 / 5e-4,
reward 1e-3) plus one unit of its last printed digit. Success and step
counts are held equal: over these short deterministic episodes no deciding
quantity lies within its bar of a threshold, so the bound on differing
outcomes is 0. Depths are cut: ≤ 120 steps, one or two CG offsets.
"""

from __future__ import annotations

import contextlib
import functools
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from test_torch_parity_utils import KeyChain, np_tree, reset_key_left, step_obs_draws, to_torch
from tvc_ai_torch import diagnose_cg, inspect_policy, lqr_balance, scripted_controller
from tvc_ai_torch.agents import sac as t_sac
from tvc_ai_torch.convert import env_params_from_numpy, sac_state_from_numpy
from tvc_ai_torch.training import dagger
from tvc_ai_torch.training import demos as t_demos
from tvc_ai_tpu.agents import sac as j_sac
from tvc_ai_tpu.config import build_env_params as j_build_env_params
from tvc_ai_tpu.config import load_config as j_load_config
from tvc_ai_tpu.env.types import EnvParams
from tvc_ai_tpu.training import demos as j_demos

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
HIDDEN = (32, 32)
NUM = re.compile(r"[-+]?\d+(?:\.\d+)?(?:e[-+]?\d+)?")
# the port's design_lqr(EnvParams()) on the CPU (float32)
DESIGN = dict(
    gain=[-0.028491921722888947, 0.0, -2.65153431892395, -0.6912903189659119, 0.0,
          -0.4013003408908844],
    gain_pitch=[-0.028491921722888947, 0.0, 2.65153431892395, -0.6912903189659119, 0.0,
                0.4013003408908844],
    z_eq=0.49893999099731445, trim_slope=-1.7831356525421143,
    trim_slope_pitch=1.7831356525421143,
)


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"ref_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_script(name: str, argv: list[str], monkeypatch) -> tuple[int, str]:
    """The reference script's exit code and standard output."""
    main = load_script(name).main
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return captured(main)


def captured(fn, *args, **kwargs) -> tuple:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args, **kwargs)
    return rc, out.getvalue()


def assert_lines_agree(port: str, ref: str, atol: float = 5e-5, rtol: float = 5e-4) -> int:
    """Line by line: the same text, integers equal, decimals within the bar
    plus one unit of the last printed digit. Returns the lines compared."""
    p_lines, r_lines = port.strip().splitlines(), ref.strip().splitlines()
    assert len(p_lines) == len(r_lines), (port, ref)
    for p, r in zip(p_lines, r_lines):
        assert NUM.sub("#", p) == NUM.sub("#", r), (p, r)
        for a, b in zip(NUM.findall(p), NUM.findall(r)):
            if "." not in b and "e" not in b:
                assert a == b, (p, r)
                continue
            digits = len(b.split(".")[1].split("e")[0]) if "." in b else 0
            assert abs(float(a) - float(b)) <= atol + rtol * abs(float(b)) + 10.0 ** -digits, (
                p, r)
    return len(r_lines)


def write_agent(tmp_path: Path, obs_dim: int, seed: int = 0) -> tuple[Path, Path]:
    """A seeded flax SACState as the reference's msgpack, and the same
    weights as the port's ``student.pt``."""
    j_state = j_sac.init(jax.random.PRNGKey(seed), obs_dim, 2, j_sac.SACConfig(hidden_dims=HIDDEN))
    ref = tmp_path / "agent.msgpack"
    ref.write_bytes(serialization.msgpack_serialize(
        {"state": serialization.to_state_dict(j_state)}))
    cfg = t_sac.SACConfig(hidden_dims=HIDDEN)
    t_state = sac_state_from_numpy(np_tree(j_state), cfg, obs_dim, 2, device="cpu")
    port = tmp_path / "student.pt"
    dagger.save_student(port, t_state.actor, cfg, obs_dim, 2)
    return ref, port


def port_actor(path: Path, obs_dim: int):
    from tvc_ai_torch.eval.evaluate import load_agent_state

    return load_agent_state(path, obs_dim, 2, t_sac.SACConfig(hidden_dims=HIDDEN), "cpu").actor


def single_draws(key, jp):
    """One env's reset draws from ``reset(key)`` and a ``step_draws(t)``
    replaying, in order, the IMU noise / dropout draws of the key the state
    carries."""
    reset = KeyChain(jp).reset(key[None])
    chain = [reset_key_left(key, jp)]

    def step_draws(t):
        assert t == len(chain) - 1, "step draws are replayed in order"
        k, d = step_obs_draws(chain[-1], jp)
        chain.append(k)
        return (to_torch(d["n_imu"]) if "n_imu" in d else None,
                to_torch(d["u_drop"]) if "u_drop" in d else None)

    return reset, step_draws


@functools.lru_cache(maxsize=1)
def nominal_reset():
    """The reset draws of ``reset(PRNGKey(0), EnvParams())``: the probes'
    and ``diagnose_cg``'s (no DR, no noise; the trim channels draw nothing)."""
    return single_draws(jax.random.PRNGKey(0), EnvParams())[0]


def test_inspect_policy_matches_script(tmp_path, monkeypatch):
    """``--randomize``: DR and sensor noise on, the IMU noise replayed."""
    steps = 100
    cfg = j_load_config(None)
    cfg.env.domain_randomization.enabled = True
    cfg.env.domain_randomization.sensor_noise_enabled = True
    jp = j_build_env_params(cfg).replace(max_episode_steps=steps)
    import tvc_ai_tpu.config as j_config

    monkeypatch.setattr(j_config, "build_env_params", lambda c: jp)
    ref, port = write_agent(tmp_path, 10)
    argv = ["--model_path", str(ref), "--hidden", *map(str, HIDDEN), "--episodes", "2",
            "--print_every", "5", "--cpu", "--randomize"]
    rc, want = run_script("inspect_policy", argv, monkeypatch)
    draws = {ep: single_draws(jax.random.PRNGKey(100 + ep), jp) for ep in range(2)}
    _, got = captured(inspect_policy.inspect, port_actor(port, 10), env_params_from_numpy(jp),
                      2, 5, "cpu", draws=draws.get)
    assert rc == 0
    assert assert_lines_agree(got, want, atol=1e-3, rtol=1e-3) >= 8


def test_diagnose_cg_matches_script(tmp_path, monkeypatch):
    """History 2 with the trim channels."""
    history, frame = 2, 14
    ref, port = write_agent(tmp_path, frame * history, seed=history)
    cgs = ["0.0", "0.03"]
    argv = ["--model_path", str(ref), "--hidden", *map(str, HIDDEN), "--history", str(history),
            "--cg", *cgs, "--steps", "120", "--cpu", "--trim_obs"]
    rc, want = run_script("diagnose_cg", argv, monkeypatch)
    reset = nominal_reset()
    params = diagnose_cg.env_params(trim_obs=True)
    _, got = captured(diagnose_cg.diagnose, port_actor(port, frame * history), params,
                      [float(c) for c in cgs], 120, history, "cpu", reset_draws=reset)
    assert rc == 0
    assert assert_lines_agree(got, want) >= 4


@pytest.fixture
def same_design(monkeypatch):
    """Both packages' ``design_lqr`` return ``DESIGN``."""
    f32 = {k: np.asarray(v, np.float32) for k, v in DESIGN.items()}
    monkeypatch.setattr(j_demos, "design_lqr",
                        lambda params: j_demos.LQRDesign(**{k: jnp.asarray(v)
                                                            for k, v in f32.items()}))
    monkeypatch.setattr(t_demos, "design_lqr", lambda params: t_demos.LQRDesign(**f32))


def test_lqr_balance_matches_script(same_design, monkeypatch):
    mode = "blind"
    argv = ["--cg", "0.0", "0.02", "--mode", mode, "--steps", "110", "--cpu"]
    if mode == "blind":
        argv.append("--verbose")
    rc, want = run_script("lqr_balance", argv, monkeypatch)
    reset = nominal_reset()
    got_rc, got = captured(lqr_balance.probe, diagnose_cg.env_params(), [0.0, 0.02], mode, 110,
                           0, mode == "blind", "cpu", reset_draws=reset)
    assert got_rc == rc
    assert "SUCCESS at t=99" in want   # cg 0 passes the window: the success branch runs
    assert assert_lines_agree(got, want) >= 2


@pytest.mark.parametrize("variant,search", [("pd", False), ("integral", False), ("cascade", True)],
                         ids=["pd", "integral", "cascade_search"])
def test_scripted_controller_matches_script(variant, search, monkeypatch):
    cgs = ["0.0"] if search else ["0.0", "0.025"]
    argv = ["--cg", *cgs, "--variant", variant, "--steps", "110", "--cpu"]
    if search:
        argv.append("--search")
    elif variant == "pd":
        argv.append("--verbose")
    rc, want = run_script("scripted_controller", argv, monkeypatch)
    reset = nominal_reset()
    got_rc, got = captured(scripted_controller.probe, diagnose_cg.env_params(),
                           [float(c) for c in cgs], variant, (5.0, 2.0, 0.2, 0.5, 1.0), 110, 0,
                           search, "--verbose" in argv, "cpu", reset_draws=reset)
    assert got_rc == rc
    assert assert_lines_agree(got, want) >= len(cgs)


def test_scripted_search_rows_equal_sequential_rollouts():
    """The batched grid gives each gain set the outcome of its own rollout,
    rows that end at different steps (93, 111, 126) and one that survives
    the horizon included."""
    params = diagnose_cg.env_params()
    grid = [(3.0, 1.0, 0.0, 0.0, 0.0), (8.0, 2.0, 0.0, 0.0, 0.0), (5.0, 2.0, 0.4, 0.0, 0.0),
            (20.0, 0.5, 0.0, 0.0, 0.0)]
    batched = scripted_controller.rollout(params, 0.01, grid, "cascade", 130, 0, "cpu")
    alone = [scripted_controller.rollout(params, 0.01, [g], "cascade", 130, 0, "cpu")[0]
             for g in grid]
    assert batched == alone
    assert len({d for _, d, _ in batched}) == 4   # three deaths at distinct steps, one None
