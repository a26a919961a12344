"""The batched env alone through
``tvc_ai_torch.env.rocket_env.batched_step_autoreset``: uniform random
actions in [-1, 1) drawn on the device (no actor, no safety projection),
then the env step with its autoreset, one call a step."""

from __future__ import annotations

import torch

from portbench import draws, tracing
from portbench.entries._env import NUMBERS, EnvRun  # noqa: F401  (NUMBERS: the entry's)


class Run(EnvRun):
    def act_draws(self, n: int, gen: torch.Generator) -> dict:
        return {"u_act": draws.uniform((n, 2), gen, self.device)}

    def program_chunk(self, state, obs, steps):
        rewards, terminated, truncated = [], [], []
        for d in steps:
            with tracing.span(tracing.PROGRAM):
                state, out, obs = self.port.step(state, d["u_act"], d)
            rewards.append(out.reward)
            terminated.append(out.terminated)
            truncated.append(out.truncated)
        return state, obs, (rewards, terminated, truncated)

    def ref_action(self, p, obs, d, lower):
        return d["u_act"].to(p.dtype)
