"""What the env entries share: a batch of ``n`` envs stepped in chunks of
``chunk_steps`` with autoreset, every random number made from the seed on
the device and handed to the program through its draws parameters, and the
check against the plain reference.

The check follows two chunks of the envs sampled from the seed
(``check_rows`` of them): the first warm-up chunk from the reference's own
reset, so one chunk is judged on data the program did not make, and the
window's last chunk from the program's state at its start (rocket
trajectories part on rounding, so the reference can only follow the
program's long runs chunk by chunk). The first reset is checked by itself.
The numbers are ``check.chunk_numbers`` over both chunks' envs together and
``start_gap``.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench import check, draws, reference, tracing, yardsticks
from portbench.reference import env as ref_env
from portbench.reference.params import from_config

NUMBERS = check.NUMBERS
ROWS_SEED = -3  # the chunk index whose seed draws the checked rows


def flat(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """A dataclass tree of tensors as a flat dict keyed by field path."""
    if isinstance(tree, dict):
        return dict(tree)
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if dataclasses.is_dataclass(v):
            out.update(flat(v, f"{prefix}{f.name}."))
        elif v is not None:
            out[f"{prefix}{f.name}"] = v
    return out


def _rows_t(x, rows: torch.Tensor) -> torch.Tensor:
    """(steps, rows) of a (steps, N) tensor or a list of (N,) tensors."""
    if isinstance(x, torch.Tensor):
        return x.index_select(1, rows)
    return torch.stack([t.index_select(0, rows) for t in x])


def _f32(x):
    if isinstance(x, dict):
        return {k: _f32(v) for k, v in x.items()}
    return x.float() if x.is_floating_point() else x


def _take(state, obs, rows: torch.Tensor) -> dict:
    """The sampled envs' state and observation."""
    return {"state": {k: v.index_select(0, rows) for k, v in flat(state).items()},
            "obs": obs.index_select(0, rows)}


def _answers(state, obs, outs, rows: torch.Tensor) -> dict:
    """The sampled envs' end state, observation and (steps, rows) outputs."""
    return {**_take(state, obs, rows), "reward": _rows_t(outs[0], rows),
            "terminated": _rows_t(outs[1], rows), "truncated": _rows_t(outs[2], rows)}


def _cat(a: dict, b: dict) -> dict:
    """Two chunks' answers as one set of rows."""
    return {"state": {k: torch.cat([v, b["state"][k]]) for k, v in a["state"].items()},
            "obs": torch.cat([a["obs"], b["obs"]]),
            **{k: torch.cat([a[k], b[k]], dim=1) for k in ("reward", "terminated", "truncated")}}


class Port:
    """The port's env, built from the configuration as a user's run builds it."""

    def __init__(self, cfg: dict, p, n: int, device):
        from tvc_ai_torch.config import build
        from tvc_ai_torch.config.schema import FrameworkConfig
        from tvc_ai_torch.env import rocket_env

        self.rocket_env, self.n, self.device = rocket_env, n, device
        self.fc = FrameworkConfig.from_dict(cfg)
        self.env_params = build.build_env_params(self.fc)
        self.loop_cfg = build.build_loop_config(self.fc)
        if self.loop_cfg.obs_dim != p.obs_dim:
            raise ValueError(f"the port's obs width {self.loop_cfg.obs_dim}, "
                             f"the file's {p.obs_dim}")

    def reset_draws(self, d: dict):
        return self.rocket_env.ResetDraws(**d)

    def reset(self, d: dict):
        return self.rocket_env.reset(self.env_params, self.n, self.device,
                                     draws=self.reset_draws(d))

    def step(self, state, action, d: dict):
        """``batched_step_autoreset`` with the step's draws ``d``."""
        return self.rocket_env.batched_step_autoreset(
            state, action, self.env_params, n_imu=d.get("n_imu"),
            reset_draws=self.reset_draws(d["reset"]), u_drop=d.get("u_drop"))


class EnvRun:
    """One cell's run of an env entry; subclasses give the action's draws,
    the program's chunk and the reference's action."""

    uses_actor = False

    def __init__(self, spec: dict, seed: int, device, n_envs: int | None = None,
                 system: str = "program"):
        traffic, cfg = spec["traffic"], spec["config"]["config"]
        if traffic["warmup_chunks"] < 1:
            raise ValueError("the check follows the first warm-up chunk: warmup_chunks >= 1")
        self.p = p = from_config(cfg)
        self.n = n_envs or cfg["training"]["num_envs"]
        self.steps, self.seed, self.device = traffic["chunk_steps"], seed, device
        self.gen = torch.Generator(device=device)
        self.weights = draws.weights(p, seed, device) if self.uses_actor else None
        self.flops_per_env_step = yardsticks.k1_flops_per_env(p.rocket.substeps) + (
            yardsticks.actor_flops_per_row(p) if self.uses_actor else 0)
        if system == "program":
            self.port = Port(cfg, p, self.n, device)
            self.build_program(self.port)
        elif system == "control":
            self.port, self.lower = None, from_config(cfg, torch.bfloat16)
        else:
            raise ValueError(f"system {system!r}: want 'program' or 'control'")
        cpu_gen = torch.Generator().manual_seed(draws.chunk_seed(seed, ROWS_SEED))
        rows = torch.randperm(self.n, generator=cpu_gen)[:min(traffic["check_rows"], self.n)]
        self.rows = rows.sort().values.to(device)

    # ----------------------------------------------------- given by the entry
    def build_program(self, port: Port) -> None:
        """Whatever the program's chunk needs beyond the env (the actor)."""

    def act_draws(self, n: int, gen: torch.Generator) -> dict:
        raise NotImplementedError

    def program_chunk(self, state, obs, steps):
        """Step the chunk whose draws ``steps`` yields through the program's
        entry; returns (state, obs, (rewards, terminated, truncated))."""
        raise NotImplementedError

    def ref_action(self, p, obs: torch.Tensor, d: dict, lower: bool) -> torch.Tensor:
        raise NotImplementedError

    # --------------------------------------------------------------- the run
    def _draws(self, c: int):
        return draws.for_chunk(self.p, self.n, self.seed, c, self.steps, self.act_draws,
                               self.gen, self.device)

    def start(self) -> None:
        d0 = draws.first_reset(self.p, self.n, self.seed, self.gen, self.device)
        if self.port is not None:
            self.state, self.obs = self.port.reset(d0)
        else:
            self.state, self.obs = ref_env.reset(
                self.lower, {k: v.to(torch.bfloat16) for k, v in d0.items()})
        del d0
        self.start_rows = _take(self.state, self.obs, self.rows)

    def chunk(self, c: int) -> None:
        # the state at the chunk's start is kept by reference (the program's
        # step returns new tensors), for the check of the window's last chunk
        self.prev, self.last = (self.state, self.obs), c
        made = self._draws(c)

        def steps():
            for _ in range(self.steps):
                with tracing.span(tracing.DRAWS):
                    d = next(made)
                yield d

        if self.port is not None:
            self.state, self.obs, self.outs = self.program_chunk(self.state, self.obs, steps())
        else:
            self.state, self.obs, *outs = reference.chunk(
                self.lower, lambda p, o, d: self.ref_action(p, o, d, True), self.state,
                self.obs, steps())
            self.outs = tuple(outs)
        if c == 0:  # set-up: the first chunk's answers, for the check
            self.first = _answers(self.state, self.obs, self.outs, self.rows)

    def _ref_chunk(self, c: int, state: dict, obs: torch.Tensor) -> dict:
        steps = [draws.rows(d, self.rows) for d in self._draws(c)]
        state, obs, rew, term, trunc = reference.chunk(
            self.p, lambda p, o, d: self.ref_action(p, o, d, False), state, obs, steps)
        return {"state": state, "obs": obs, "reward": rew, "terminated": term,
                "truncated": trunc}

    def check(self) -> dict[str, float]:
        last = _answers(self.state, self.obs, self.outs, self.rows)
        at_last = _take(*self.prev, self.rows)
        self.state = self.obs = self.outs = self.prev = self.port = None
        ref_state, ref_obs = ref_env.reset(
            self.p, draws.rows(draws.first_reset(self.p, self.n, self.seed, self.gen,
                                                 self.device), self.rows))
        start = _f32(self.start_rows)
        numbers = {"start_gap": check.start_gap(start["state"], start["obs"], ref_state,
                                                ref_obs)}
        ref = _cat(self._ref_chunk(0, ref_state, ref_obs),
                   self._ref_chunk(self.last, _f32(at_last["state"]), _f32(at_last["obs"])))
        chunk, self.gap_max_at = check.chunk_numbers(_f32(_cat(self.first, last)), ref)
        return {**chunk, **numbers}
