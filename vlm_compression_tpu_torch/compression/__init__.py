"""Compression subsystem of the port: calibration engine, adapters and
pruners.  ``load_pruner`` resolves a registered pruner by name and
instantiates it with config kwargs (port of
``vlm_compression_tpu/compression/__init__.py``)."""

from vlm_compression_tpu_torch.common.registry import registry


def load_pruner(name: str, model, data_loader, cfg=None, **kwargs):
    cls = registry.get_pruner_class(name)
    cfg = dict(cfg or {})
    cfg.update(kwargs)
    return cls(model=model, data_loader=data_loader, **cfg)


# register pruners on import
from vlm_compression_tpu_torch.compression import pruners  # noqa: E402,F401
