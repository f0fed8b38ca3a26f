"""Config trees: YAML ``model:/datasets:/run:`` sections and dot-list
overrides (port of ``vlm_compression_tpu/common/config.py``).

``ConfigNode`` is a dict with attribute access, deep merge, dot-path get
and set and ``to_dict``; ``Config`` loads a project yaml, merges the
model's default yaml under its ``model`` section and applies ``--options``
overrides last.  Files and override values are read by the port's own
YAML-subset reader (``common/_yaml.py``) on every host, so the CPU and the
card read a config the same way.
"""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Iterable, Mapping, Optional

from vlm_compression_tpu_torch.common._yaml import safe_load


class ConfigNode(dict):
    """dict with attribute access and deep merge. Values stay plain."""

    def __init__(self, data: Optional[Mapping] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = self._wrap(v)

    @staticmethod
    def _wrap(v):
        if isinstance(v, Mapping) and not isinstance(v, ConfigNode):
            return ConfigNode(v)
        if isinstance(v, list):
            return [ConfigNode._wrap(x) for x in v]
        return v

    def __setattr__(self, k, v):
        self[k] = self._wrap(v)

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k) from None

    def __setitem__(self, k, v):
        super().__setitem__(k, self._wrap(v))

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], ConfigNode):
                node[part] = ConfigNode()
            node = node[part]
        node[parts[-1]] = value

    def merge(self, other: Mapping) -> "ConfigNode":
        """Deep-merge ``other`` over self (other wins), returning self."""
        for k, v in other.items():
            if k in self and isinstance(self[k], ConfigNode) and \
                    isinstance(v, Mapping):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def to_dict(self) -> Dict:
        out: Dict = {}
        for k, v in self.items():
            if isinstance(v, ConfigNode):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, ConfigNode) else x
                          for x in v]
            else:
                out[k] = v
        return out

    def copy(self) -> "ConfigNode":
        return ConfigNode(copy.deepcopy(self.to_dict()))

    def pretty(self) -> str:
        return json.dumps(self.to_dict(), indent=2, default=str)


def _parse_scalar(text: str) -> Any:
    """An ``--options`` value, read as a YAML document (a scalar, or a flow
    sequence such as a path list)."""
    return safe_load(text)


def apply_dot_overrides(cfg: ConfigNode,
                        options: Optional[Iterable[str]]) -> ConfigNode:
    """Apply ``key.path=value`` overrides (the ``--options`` dot-list)."""
    for opt in options or []:
        if "=" not in opt:
            raise ValueError(f"override '{opt}' is not of the form key=value")
        key, value = opt.split("=", 1)
        cfg.set_path(key.strip(), _parse_scalar(value))
    return cfg


def load_yaml(path: str) -> ConfigNode:
    with open(path) as f:
        return ConfigNode(safe_load(f.read()) or {})


class Config:
    """Top-level experiment config: the three-section tree.

    Parameters
    ----------
    cfg_path : YAML file with ``model:``, ``datasets:``, ``run:`` sections.
    options  : iterable of ``a.b.c=value`` overrides applied last.
    defaults : optional mapping model ``arch`` → default-YAML path, or a
               callable (arch, model_type) → path; merged *under* the user
               model section.
    """

    def __init__(self, cfg_path: Optional[str] = None, options=None,
                 defaults=None, tree: Optional[Mapping] = None):
        cfg = ConfigNode(tree) if tree is not None else (
            load_yaml(cfg_path) if cfg_path else ConfigNode())
        model_user = cfg.get("model", ConfigNode())
        if defaults:
            arch = model_user.get("arch")
            model_type = model_user.get("model_type")
            default_path = None
            if callable(defaults):
                default_path = defaults(arch, model_type)
            elif arch in defaults:
                default_path = defaults[arch]
            if default_path:
                base = load_yaml(default_path).get("model", ConfigNode())
                merged = ConfigNode(base.to_dict())
                merged.merge(model_user)
                cfg["model"] = merged
        apply_dot_overrides(cfg, options)
        self.config = cfg

    @property
    def model_cfg(self) -> ConfigNode:
        return self.config.get("model", ConfigNode())

    @property
    def datasets_cfg(self) -> ConfigNode:
        return self.config.get("datasets", ConfigNode())

    @property
    def run_cfg(self) -> ConfigNode:
        return self.config.get("run", ConfigNode())

    def pretty_print(self) -> str:
        return self.config.pretty()

    def to_dict(self) -> Dict:
        return self.config.to_dict()
