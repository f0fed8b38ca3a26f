"""Name → class registry (port of
``vlm_compression_tpu/common/registry.py``): the seven kinds (model,
task, builder, processor, pruner, lr_scheduler, runner), a path and state
store, and deferred registration.

A name the port does not register raises ``KeyError`` saying it is not
ported yet, with the names that are.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

_KINDS = ("model", "task", "builder", "processor", "pruner", "lr_scheduler",
          "runner")


class Registry:
    def __init__(self):
        self.mapping = {f"{kind}_name_mapping": {} for kind in _KINDS}
        self._paths: Dict[str, str] = {}
        self._state: Dict[str, Any] = {}
        self._lazy: Dict[str, List[Callable]] = {}

    def register_lazy(self, kind: str, loader: Callable) -> None:
        """``loader()`` runs once, the first time a ``kind`` lookup misses
        (or the names of ``kind`` are listed); the lookup then retries."""
        self._lazy.setdefault(kind, []).append(loader)

    def _run_lazy(self, kind: str) -> None:
        for loader in self._lazy.pop(kind, ()):
            loader()

    def _register(self, kind: str, name: str):
        def wrap(cls):
            table = self.mapping[f"{kind}_name_mapping"]
            if name in table and table[name] is not cls:
                raise KeyError(f"{name!r} already registered as {table[name]}")
            table[name] = cls
            return cls

        return wrap

    def _get(self, kind: str, name: str):
        table = self.mapping[f"{kind}_name_mapping"]
        if name not in table:
            self._run_lazy(kind)
        cls = table.get(name)
        if cls is None:
            raise KeyError(f"{kind} {name!r} is not ported yet; ported: "
                           f"{sorted(table)}")
        return cls

    def list_names(self, kind: str) -> List[str]:
        self._run_lazy(kind)
        return sorted(self.mapping[f"{kind}_name_mapping"])

    # -- one pair of methods a kind ----------------------------------------
    def register_model(self, name: str):
        return self._register("model", name)

    def get_model_class(self, name: str):
        return self._get("model", name)

    def register_task(self, name: str):
        return self._register("task", name)

    def get_task_class(self, name: str):
        return self._get("task", name)

    def register_builder(self, name: str):
        return self._register("builder", name)

    def get_builder_class(self, name: str):
        return self._get("builder", name)

    def register_processor(self, name: str):
        return self._register("processor", name)

    def get_processor_class(self, name: str):
        return self._get("processor", name)

    def register_pruner(self, name: str):
        return self._register("pruner", name)

    def get_pruner_class(self, name: str):
        return self._get("pruner", name)

    def register_lr_scheduler(self, name: str):
        return self._register("lr_scheduler", name)

    def get_lr_scheduler_class(self, name: str):
        return self._get("lr_scheduler", name)

    def register_runner(self, name: str):
        return self._register("runner", name)

    def get_runner_class(self, name: str):
        return self._get("runner", name)

    # -- paths and state ---------------------------------------------------
    def register_path(self, name: str, path: str) -> None:
        self._paths[name] = path

    def get_path(self, name: str) -> str:
        return self._paths[name]

    def register(self, name: str, obj: Any) -> None:
        self._state[name] = obj

    def get(self, name: str, default: Any = None) -> Any:
        return self._state.get(name, default)


registry = Registry()
