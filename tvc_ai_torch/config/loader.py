"""YAML front-end + dotted-path overrides for the typed config tree.

Counterpart of ``tvc_ai_tpu/config/loader.py``: one YAML file (``--config``)
plus ``key.path=value`` overrides. ``default_config_path`` is the port's own
copy of ``default.yaml``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Sequence

import yaml

from tvc_ai_torch.config.schema import FrameworkConfig


def _parse_scalar(text: str) -> Any:
    return yaml.safe_load(text)


def apply_override(data: dict, dotted: str, value: Any) -> None:
    keys = dotted.split(".")
    node = data
    for k in keys[:-1]:
        node = node.setdefault(k, {})
        if not isinstance(node, dict):
            raise TypeError(f"cannot override through non-mapping at '{k}' in '{dotted}'")
    node[keys[-1]] = value


def load_config(
    path: str | Path | None = None, overrides: Sequence[str] = ()
) -> FrameworkConfig:
    """Load YAML (or defaults when ``path`` is None) + ``a.b.c=v`` overrides."""
    data: dict = {}
    if path is not None:
        data = yaml.safe_load(Path(path).read_text()) or {}
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override '{item}' must look like key.path=value")
        key, _, raw = item.partition("=")
        apply_override(data, key.strip(), _parse_scalar(raw.strip()))
    return FrameworkConfig.from_dict(data)


def save_config(cfg: FrameworkConfig, path: str | Path) -> None:
    Path(path).write_text(yaml.safe_dump(cfg.to_dict(), sort_keys=False))


def default_config_path() -> Path:
    return Path(__file__).parent / "default.yaml"
