"""The ensemble iteration with PPO or the blend acting, against the JAX
package (CPU): the cases of ``test_torch_ensemble.py`` (same draws, same
bars) for the two actors whose iterations differ most, PPO (GAE and its
epochs after the rollout, from the carry's key) and the performance-weighted
blend of all three members (three normals split from one key)."""

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


@pytest.fixture(scope="module", params=["ppo", "ensemble"])
def run(request):
    return make_run(request.param)
