"""Typed config tree, YAML front-end and the bridge to the port's runtime types."""

from tvc_ai_torch.config.build import (  # noqa: F401
    build_env_params,
    build_loop_config,
    build_sac_config,
)
from tvc_ai_torch.config.loader import (  # noqa: F401
    default_config_path,
    load_config,
    save_config,
)
from tvc_ai_torch.config.schema import FrameworkConfig  # noqa: F401
