"""The fused train iteration's hierarchical mode, alone and with the other
three extensions, against the JAX package (CPU): the checks of
``test_torch_train_loop_extensions.py`` (its docstring gives the method and
the bars). With hierarchical mode the SAC actor and the replay see [obs ‖
goal one-hot], finished episodes log their goal into the ring and draw fresh
goals on the replayed Gumbel draws, and the high level takes its masked
REINFORCE step at the iteration's end.
"""

from __future__ import annotations

import pytest

from test_torch_train_loop_extensions import (
    check_convert,
    check_counters_ring_and_goals_match,
    check_env_state_and_obs_match,
    check_extension_states_match,
    check_replay_rows_match,
    check_sac_params_and_metrics_match,
    run_case,
)


@pytest.fixture(scope="module", params=["all_four", "hierarchical"])
def run(request):
    return run_case(request.param)


def test_convert_carries_extension_fields(run):
    check_convert(run)


def test_iteration_env_state_and_obs_match(run):
    check_env_state_and_obs_match(run)


def test_iteration_replay_rows_match(run):
    check_replay_rows_match(run)


def test_iteration_counters_ring_and_goals_match(run):
    check_counters_ring_and_goals_match(run)


def test_iteration_sac_params_and_metrics_match(run):
    check_sac_params_and_metrics_match(run)


def test_iteration_extension_states_match(run):
    check_extension_states_match(run)
