"""Small shared utilities (port of ``vlm_compression_tpu/common/utils.py``):
job-id timestamps, URL checks, the ``LOCAL_PATHS`` map of local snapshot
directories, cache and package paths, camel → snake case."""

from __future__ import annotations

import datetime
import os
import re
import shutil
import urllib.parse
from typing import Dict, Optional

from vlm_compression_tpu_torch.common.registry import registry


def now() -> str:
    """Job-id timestamp (to ten minutes)."""
    return datetime.datetime.now().strftime("%Y%m%d%H%M")[:-1]


def is_url(path: str) -> bool:
    return urllib.parse.urlparse(path).scheme in ("http", "https")


# local snapshot directories of pretrained weights and tokenizers
LOCAL_PATHS: Dict[str, str] = {}


def register_local_path(name: str, path: str) -> None:
    LOCAL_PATHS[name] = path


def get_local_path(name: str, default: Optional[str] = None
                   ) -> Optional[str]:
    return LOCAL_PATHS.get(name, default)


def get_cache_path(rel_path: str = "") -> str:
    root = registry.get_path("cache_root") if _has_path("cache_root") else \
        os.path.expanduser("~/.cache/vlm_compression_tpu")
    return os.path.join(root, rel_path)


def _has_path(name: str) -> bool:
    try:
        return registry.get_path(name) is not None
    except KeyError:
        return False


def get_abs_path(rel_path: str) -> str:
    """``rel_path`` under the port's package directory."""
    lib_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(lib_root, rel_path)


def cleanup_dir(path: str) -> None:
    if os.path.isdir(path):
        shutil.rmtree(path)


_CAMEL = re.compile(r"(?<!^)(?=[A-Z])")


def camel_to_snake(name: str) -> str:
    return _CAMEL.sub("_", name).lower()
