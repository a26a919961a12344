"""Reward-hacking detection — five indicators over an episode window.

Counterpart of ``tvc_ai_tpu/training/hacking.py``, a host-only copy: the
indicators are computed over a rolling 100-episode window, the hacking score
is their mean, and a warning fires above 0.7. The trainer feeds it the
finished episodes it drains from the carry's ring once per iteration.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class HackingReport:
    score: float
    indicators: dict[str, float]
    is_hacking: bool


@dataclass
class RewardHackingDetector:
    window_size: int = 100
    warn_threshold: float = 0.7
    # thresholds mirroring the reference's checks
    high_reward: float = 1000.0        # "high reward" bar for mismatch check
    impossible_reward: float = 2000.0  # reward no honest policy reaches w/o success
    long_episode: int = 900            # near-max episodes without success
    rewards: deque = field(default_factory=lambda: deque(maxlen=100))
    successes: deque = field(default_factory=lambda: deque(maxlen=100))
    lengths: deque = field(default_factory=lambda: deque(maxlen=100))

    def __post_init__(self):
        self.rewards = deque(maxlen=self.window_size)
        self.successes = deque(maxlen=self.window_size)
        self.lengths = deque(maxlen=self.window_size)

    def add_episode(self, reward: float, success: bool, length: int) -> None:
        self.rewards.append(float(reward))
        self.successes.append(float(bool(success)))
        self.lengths.append(int(length))

    def detect_hacking(self) -> HackingReport:
        import numpy as np

        n = len(self.rewards)
        if n < max(10, self.window_size // 10):
            return HackingReport(0.0, {}, False)

        rewards = np.asarray(self.rewards, dtype=np.float64)
        successes = np.asarray(self.successes, dtype=np.float64)
        lengths = np.asarray(self.lengths, dtype=np.float64)
        success_rate = successes.mean()

        indicators: dict[str, float] = {}

        # 1. rising rewards with flat/zero success
        half = n // 2
        reward_trend = rewards[half:].mean() - rewards[:half].mean()
        indicators["reward_success_mismatch"] = float(
            reward_trend > 0 and rewards.mean() > self.high_reward * 0.25
            and success_rate < 0.1
        )

        # 2. living long without succeeding (timeout farming)
        indicators["long_episodes_no_success"] = float(
            (lengths > self.long_episode).mean() > 0.5 and success_rate < 0.1
        )

        # 3. reward variance wildly exceeding success variance
        reward_var = rewards.var() / (abs(rewards.mean()) + 1e-8) ** 2
        success_var = successes.var()
        indicators["variance_mismatch"] = float(
            reward_var > 1.0 and success_var < 0.01 and success_rate < 0.5
        )

        # 4. reward spikes (episodes far above the window median)
        median = np.median(rewards)
        spread = np.abs(rewards - median).mean() + 1e-8
        indicators["reward_spikes"] = float(
            (np.abs(rewards - median) > 10.0 * spread).any()
        )

        # 5. impossible performance: huge reward at zero success
        indicators["impossible_performance"] = float(
            rewards.mean() > self.impossible_reward and success_rate == 0.0
        )

        score = float(np.mean(list(indicators.values())))
        return HackingReport(score, indicators, score > self.warn_threshold)
