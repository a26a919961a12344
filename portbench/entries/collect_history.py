"""Monte-Carlo rollout of the transformer policy through
``tvc_ai_torch.training.loop.collect`` with the observation-history window:
the actor that ``sac.make_actor`` builds from the configuration, on the
seed's weights, acts on the window of the last ``history_len`` observations;
the tanh-Gaussian sample; the safety projection on the newest frame; the env
step with its autoreset; the window moved on, refilled where an episode
ended. A chunk of steps a call. The draws are the actor's exploration noise
and the env's; the reference acts with ``reference.transformer`` and keeps
its window with ``reference.history``.

The checked ``obs`` is the window. Besides the env entries' numbers the
check reports ``actor_gap``: the widest |p − r| / (1 + |r|) over the mean and
log-std of the program's actor and the reference's, both fed the checked
envs' last window of the run (the program's own), at the checked rows. It
holds the actor's arithmetic alone to float32, which the env's numbers
cannot: most actions leave the tanh saturated, and the env's limits are
wide enough for rounding that rocket trajectories amplify.
"""

from __future__ import annotations

import torch

from portbench import check, draws, tracing, transformer_yardsticks, yardsticks
from portbench.entries._env import EnvRun, _answers, _cat, _f32, _take
from portbench.reference import env as ref_env, history, policy, transformer

NUMBERS = (*check.NUMBERS, "actor_gap")
WEIGHTS_SEED = -4  # the chunk index whose seed draws the actor's weights


def param_shapes(s) -> list[tuple[str, tuple[int, ...], float | None]]:
    """(name, shape, scale) of each parameter the actor reads, named as in
    the flax tree: a Dense weight (out, in) is drawn normal times ``scale``,
    a bias normal times 0.05, a LayerNorm scale (``scale`` None) as
    1 + 0.1 normal. The scales are those of the port's init: 1/√in for the
    encoder layers and the squeeze-excitation (lecun), √(2 / max(out, in))
    for the embedding and the head (orthogonal, gain √2)."""
    out: list[tuple[str, tuple[int, ...], float | None]] = []

    def dense(name, i, o, lecun):
        out.append((f"{name}.weight", (o, i), (1.0 / i if lecun else 2.0 / max(o, i)) ** 0.5))
        out.append((f"{name}.bias", (o,), 0.05))

    def norm(name, width):
        out.append((f"{name}.weight", (width,), None))
        out.append((f"{name}.bias", (width,), 0.05))

    d = s.d_model
    dense("Dense_0", s.token_dim, d, False)
    for i in range(s.num_layers):
        layer = f"EncoderLayer_{i}"
        norm(f"{layer}.LayerNorm_0", d)
        for proj in ("query", "key", "value", "out"):
            dense(f"{layer}.MultiHeadDotProductAttention_0.{proj}", d, d, True)
        norm(f"{layer}.LayerNorm_1", d)
        dense(f"{layer}.Dense_0", d, s.feed_forward_dim, True)
        dense(f"{layer}.Dense_1", s.feed_forward_dim, d, True)
    norm("LayerNorm_0", d)
    dense("SqueezeExcitation_0.Dense_0", d, s.squeezed, True)
    dense("SqueezeExcitation_0.Dense_1", s.squeezed, d, True)
    width = d
    for i, h in enumerate(s.head_hidden_dims):
        dense(f"_Head_0.Dense_{i}", width, h, False)
        norm(f"_Head_0.LayerNorm_{i}", h)
        width = h
    dense(f"_Head_0.Dense_{len(s.head_hidden_dims)}", width, 2 * s.action_dim, False)
    return out


def weights(s, seed: int, device) -> dict[str, torch.Tensor]:
    """The actor's weights from the seed, in one draw on the device, keyed
    by ``param_shapes``' names."""
    shapes = param_shapes(s)
    gen = torch.Generator(device=device)
    gen.manual_seed(draws.chunk_seed(seed, WEIGHTS_SEED))
    flat = torch.randn(sum(torch.Size(shape).numel() for _, shape, _ in shapes), device=device,
                       generator=gen)
    out, at = {}, 0
    for name, shape, scale in shapes:
        size = torch.Size(shape).numel()
        x = flat[at:at + size].view(shape)
        at += size
        out[name] = (1.0 + 0.1 * x if scale is None else x * scale).contiguous()
    return out


class Run(EnvRun):
    def __init__(self, spec: dict, seed: int, device, n_envs: int | None = None,
                 system: str = "program"):
        self.shape = s = transformer_yardsticks.shape(spec["config"])
        self.tf_weights = weights(s, seed, device)
        super().__init__(spec, seed, device, n_envs, system)
        if s.token_dim != self.p.obs_dim * s.history_len:
            raise ValueError(f"token width {s.token_dim}, want the obs width {self.p.obs_dim} "
                             f"times history_len {s.history_len}")
        self.p.transformer = s
        self.flops_per_env_step = (yardsticks.k1_flops_per_env(self.p.rocket.substeps)
                                   + transformer_yardsticks.actor_flops_per_row(s))

    def build_program(self, port) -> None:
        from tvc_ai_torch.agents import sac
        from tvc_ai_torch.config import build
        from tvc_ai_torch.training import loop

        self.loop, cfg = loop, port.loop_cfg
        self.safety = cfg.safety if cfg.use_safety_layer else None
        self.actor = sac.make_actor(loop.policy_obs_dim(cfg), 2, build.build_sac_config(port.fc),
                                    self.device)
        params = dict(self.actor.TransformerPolicyNetwork_0.named_parameters())
        with torch.no_grad():
            for name, w in self.tf_weights.items():
                if params[name].shape != w.shape:
                    raise ValueError(f"{name}: the actor's {tuple(params[name].shape)}, "
                                     f"drawn {tuple(w.shape)}")
                params[name].copy_(w)

    def act_draws(self, n: int, gen: torch.Generator) -> dict:
        return {"n_act": torch.randn((n, 2), device=self.device, generator=gen)}

    def start(self) -> None:
        super().start()
        n, h = self.obs.shape[0], self.shape.history_len
        if self.port is not None:  # as the trainer's init_carry starts its window
            self.obs = self.obs[:, None, :].repeat(1, h, 1).reshape(n, -1)
        else:
            self.obs = history.start(self.obs, h)
        self.start_rows = _take(self.state, self.obs, self.rows)

    def program_chunk(self, state, obs, steps):
        sd = [self.loop.StepDraws(n_act=d["n_act"], n_imu=d.get("n_imu"),
                                  u_drop=d.get("u_drop"), reset=self.port.reset_draws(d["reset"]))
              for d in steps]
        with tracing.span(tracing.PROGRAM):
            r = self.loop.collect(self.actor, state, obs, self.port.env_params, len(sd),
                                  safety=self.safety, draws=sd,
                                  history_len=self.shape.history_len)
        return r.states, r.obs, (r.reward, r.terminated, r.truncated)

    def ref_actor(self, window: torch.Tensor, lower: bool):
        return transformer.actor(self.tf_weights, window, self.shape.num_heads,
                                 self.shape.sequence_length, lower)

    def ref_action(self, p, window, d, lower):
        mean, log_std = self.ref_actor(window, lower)
        action = policy.sample(mean, log_std, d["n_act"].to(mean.dtype)).to(p.dtype)
        if p.safety is None:
            return action
        return policy.safety(window[:, -p.obs_dim:], action, p.safety)

    def chunk(self, c: int) -> None:
        if self.port is not None:
            return super().chunk(c)
        # the control: the reference one precision lower in the program's place
        self.prev, self.last = (self.state, self.obs), c
        self.state, self.obs, *outs = history.chunk(
            self.lower, lambda p, o, d: self.ref_action(p, o, d, True), self.state, self.obs,
            self._draws(c))
        self.outs = tuple(outs)
        if c == 0:
            self.first = _answers(self.state, self.obs, self.outs, self.rows)

    def _ref_chunk(self, c: int, state: dict, window: torch.Tensor) -> dict:
        steps = [draws.rows(d, self.rows) for d in self._draws(c)]
        state, window, rew, term, trunc = history.chunk(
            self.p, lambda p, o, d: self.ref_action(p, o, d, False), state, window, steps)
        return {"state": state, "obs": window, "reward": rew, "terminated": term,
                "truncated": trunc}

    def _actor_gap(self, window: torch.Tensor) -> float:
        """``actor_gap`` on the checked envs' last window."""
        with torch.no_grad():
            if self.port is not None:
                got = self.actor(window)
            else:
                got = self.ref_actor(window.to(self.lower.dtype), True)
            want = self.ref_actor(window.float(), False)
        return float(check._gap(torch.cat(got, -1).float(), torch.cat(want, -1)).max())

    def check(self) -> dict[str, float]:
        last = _answers(self.state, self.obs, self.outs, self.rows)
        at_last = _take(*self.prev, self.rows)
        self.state = self.obs = self.outs = self.prev = None
        actor_gap = self._actor_gap(last["obs"])
        self.port = self.actor = None
        ref_state, ref_obs = ref_env.reset(
            self.p, draws.rows(draws.first_reset(self.p, self.n, self.seed, self.gen,
                                                 self.device), self.rows))
        ref_window = history.start(ref_obs, self.shape.history_len)
        start = _f32(self.start_rows)
        numbers = {"start_gap": check.start_gap(start["state"], start["obs"], ref_state,
                                                ref_window),
                   "actor_gap": actor_gap}
        ref = _cat(self._ref_chunk(0, ref_state, ref_window),
                   self._ref_chunk(self.last, _f32(at_last["state"]), _f32(at_last["obs"])))
        chunk, self.gap_max_at = check.chunk_numbers(_f32(_cat(self.first, last)), ref)
        return {**chunk, **numbers}
