"""Name → class registry (the subset of ``vlm_compression_tpu.common.
registry`` this slice needs: pruners, for ``load_pruner``)."""

from __future__ import annotations


class Registry:
    def __init__(self):
        self.mapping = {"pruner_name_mapping": {}}

    def register_pruner(self, name: str):
        def wrap(cls):
            table = self.mapping["pruner_name_mapping"]
            if name in table and table[name] is not cls:
                raise KeyError(f"{name!r} already registered as {table[name]}")
            table[name] = cls
            return cls

        return wrap

    def get_pruner_class(self, name: str):
        cls = self.mapping["pruner_name_mapping"].get(name)
        if cls is None:
            known = sorted(self.mapping["pruner_name_mapping"])
            raise KeyError(f"pruner {name!r} is not ported yet; ported: {known}")
        return cls


registry = Registry()
