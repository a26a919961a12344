"""The ensemble iteration with sensor dropout and actuator delay on, against
the JAX package (CPU): the cases of ``test_torch_ensemble.py`` (same draws,
same bars) with SAC acting on an env that holds the last IMU reading on a
dropout step (each step's dropout draw replayed from the env's own key, split
beside the IMU noise) and hands the physics the previous command."""

from __future__ import annotations

import pytest

from test_torch_ensemble import (  # noqa: F401  (collected here with this file's fixture)
    make_run,
    test_iteration_counters_match,
    test_iteration_env_state_and_obs_match,
    test_iteration_metrics_match,
    test_iteration_params_match,
    test_iteration_replay_rows_match,
)
from tvc_ai_tpu.env.types import EnvParams, RandomizationConfig

DROPOUT_DELAY = EnvParams(
    randomization=RandomizationConfig(enabled=True, sensor_noise_enabled=True,
                                      sensor_dropout_enabled=True, sensor_dropout_prob=0.3,
                                      actuator_delay=True),
    max_episode_steps=4,
)


@pytest.fixture(scope="module", params=["sac_dropout_delay"])
def run(request):
    out = make_run("sac", DROPOUT_DELAY)
    assert out["t"].env_states.prev_imu.shape == (16, 7)
    return out
