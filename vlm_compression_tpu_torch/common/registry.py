"""Name → class registry (the subset of ``vlm_compression_tpu.common.
registry`` the ported slices need: pruners for ``load_pruner``, tasks and
LR schedulers)."""

from __future__ import annotations

_KINDS = ("pruner", "task", "lr_scheduler")


class Registry:
    def __init__(self):
        self.mapping = {f"{kind}_name_mapping": {} for kind in _KINDS}

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
        cls = table.get(name)
        if cls is None:
            raise KeyError(f"{kind} {name!r} is not ported yet; ported: "
                           f"{sorted(table)}")
        return cls

    def register_pruner(self, name: str):
        return self._register("pruner", name)

    def get_pruner_class(self, name: str):
        return self._get("pruner", name)

    def register_task(self, name: str):
        return self._register("task", name)

    def get_task_class(self, name: str):
        return self._get("task", name)

    def register_lr_scheduler(self, name: str):
        return self._register("lr_scheduler", name)

    def get_lr_scheduler_class(self, name: str):
        return self._get("lr_scheduler", name)


registry = Registry()
