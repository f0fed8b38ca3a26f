"""PyTorch/CUDA port of ``vlm_compression_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX package, mirroring its layout
(``ops/``, ``models/``, ``compression/``, ``common/``).  It imports torch,
numpy and the standard library only.  The JAX package stays the reference:
the ``tests/test_torch_*.py`` files hold each module of this package to its
JAX counterpart on the CPU.

Every Pallas kernel on a ported path is a hand-written CUDA C++ kernel for
``sm_90a`` under ``csrc/``, built with nvcc at first use (``ops/_cuda.py``).
Entry points run on the card unless the caller passes ``device="cpu"``;
``load_model``, ``load_model_and_preprocess`` and ``load_pruner`` are the
LAVIS-style entry points.
"""

from vlm_compression_tpu_torch.common.registry import (  # noqa: E402
    registry,  # noqa: F401
)


def load_pruner(name, model, data_loader, cfg=None, **kw):
    """The pruner ``name`` over ``model`` and its calibration batches (the
    LAVIS entry point; heavy imports stay lazy)."""
    from vlm_compression_tpu_torch.compression import load_pruner as _lp

    return _lp(name, model, data_loader, cfg, **kw)


def load_model(*args, **kw):
    """``models.load_model``: the model by registry name, on the card
    unless ``device`` says otherwise."""
    from vlm_compression_tpu_torch.models import load_model as _lm

    return _lm(*args, **kw)


def load_model_and_preprocess(*args, **kw):
    """``models.load_model_and_preprocess``: (model, vis_processors,
    txt_processors)."""
    from vlm_compression_tpu_torch.models import (
        load_model_and_preprocess as _lmp,
    )

    return _lmp(*args, **kw)
