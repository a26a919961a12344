"""Monte-Carlo policy rollout through ``tvc_ai_torch.training.loop.collect``:
the SAC actor's tanh-Gaussian action on the seed's weights, the safety
projection where the configuration turns it on, then the env step with its
autoreset, a chunk of steps a call. The draws are the actor's exploration
noise and the env's; the reference acts with ``reference.policy``."""

from __future__ import annotations

import torch

from portbench import tracing
from portbench.entries._env import NUMBERS, EnvRun  # noqa: F401  (NUMBERS: the entry's)
from portbench.reference import policy


class Run(EnvRun):
    uses_actor = True

    def build_program(self, port) -> None:
        from tvc_ai_torch.agents import sac
        from tvc_ai_torch.config import build
        from tvc_ai_torch.training import loop

        self.loop = loop
        p, cfg = self.p, port.loop_cfg
        self.safety = cfg.safety if cfg.use_safety_layer else None
        self.actor = sac.make_actor(p.obs_dim, 2, build.build_sac_config(port.fc), self.device)
        layers = [f"hidden_{i}" for i in range(len(p.hidden_dims))]
        with torch.no_grad():
            for name, (w, b) in zip(layers + ["mean_head", "log_std_head"], self.weights,
                                    strict=True):
                layer = getattr(self.actor, name)
                layer.weight.copy_(w)
                layer.bias.copy_(b)

    def act_draws(self, n: int, gen: torch.Generator) -> dict:
        return {"n_act": torch.randn((n, 2), device=self.device, generator=gen)}

    def program_chunk(self, state, obs, steps):
        sd = [self.loop.StepDraws(n_act=d["n_act"], n_imu=d.get("n_imu"),
                                  u_drop=d.get("u_drop"), reset=self.port.reset_draws(d["reset"]))
              for d in steps]
        with tracing.span(tracing.PROGRAM):
            r = self.loop.collect(self.actor, state, obs, self.port.env_params, len(sd),
                                  safety=self.safety, draws=sd)
        return r.states, r.obs, (r.reward, r.terminated, r.truncated)

    def ref_action(self, p, obs, d, lower):
        return policy.act(p, self.weights, obs, d["n_act"].to(p.dtype), lower)
