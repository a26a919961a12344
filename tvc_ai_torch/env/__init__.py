"""Batched rocket-TVC environment as plain functions over tensor dataclasses,
the single-env core, and the Gymnasium classes and factories.

The Gymnasium names (``EnhancedRocketTVCEnv``, ``RocketTVCEnv``,
``register_envs``, ``make_*_env``) are exported lazily, so importing this
package (and the core, ``env.single``) does not need gymnasium.
"""

from importlib import import_module

_LAZY = {
    "EnhancedRocketTVCEnv": "tvc_ai_torch.env.wrappers",
    "RocketTVCEnv": "tvc_ai_torch.env.wrappers",
    "RocketConfig": "tvc_ai_torch.env.single",
    "register_envs": "tvc_ai_torch.env.registration",
    "make_training_env": "tvc_ai_torch.env.registration",
    "make_evaluation_env": "tvc_ai_torch.env.registration",
    "make_debug_env": "tvc_ai_torch.env.registration",
    "make_legacy_env": "tvc_ai_torch.env.registration",
}


def __getattr__(name: str):
    if name in _LAZY:
        return getattr(import_module(_LAZY[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
