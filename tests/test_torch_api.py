"""The port's package-level entry points vs the JAX package's on the CPU,
at tiny size: ``load_model``, ``load_model_and_preprocess`` and
``load_pruner``.

The model of each arch JAX's ``load_model`` builds at tiny size
(InstructBLIP-T5, the stage-1 BLIP-2) has JAX's config field for field and
JAX's parameter names and shapes; InstructBLIP-Vicuna, whose tiny init the
JAX factory cannot run, has the JAX factory's config; a checkpoint (the
port's ``torch.save`` of a state dict, here the JAX model's weights
carried across by the weight bridge) loads bit for bit; with no
``device`` the loaders want the card and raise without one.  The
processors give JAX's arrays on one image, bit for bit (the train crop
from one seed).  ``load_pruner`` builds the class JAX's does for every
registered name, and its Wanda prune of a tiny ViT keeps JAX's masks bit
for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlm_compression_tpu as J
import vlm_compression_tpu_torch as T
from test_torch_models import numpy_tree
from test_torch_pipeline import _copy_spine
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.models import eva_vit as JV
from vlm_compression_tpu_torch.models.bridge import (
    export_masks,
    flatten,
    load_jax_variables,
)

# the archs JAX's ``load_model`` builds at tiny size (its factory's init of
# InstructBLIP-Vicuna fails on its own dummy batch: the labels and the
# logits it shifts differ in length)
ARCHS = [("blip2_t5_instruct", "flant5xl"), ("blip2", "pretrain")]
VICUNA = ("blip2_vicuna_instruct", "vicuna7b")


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items()}


def _same_fields(got, want):
    """Every field of the port's config equals JAX's (the JAX knobs the
    port leaves out are not compared)."""
    g, w = _fields(got), _fields(want)
    for key, value in g.items():
        if isinstance(value, dict):
            _same_fields(getattr(got, key), getattr(want, key))
        else:
            assert value == w[key], key


@pytest.mark.parametrize("arch,model_type", ARCHS)
def test_load_model_matches_jax(arch, model_type):
    jm, variables = J.load_model(arch, model_type, tiny=True)
    tm = T.load_model(arch, model_type, tiny=True, device="cpu")
    _same_fields(tm.cfg, jm.cfg)
    want = {".".join(p): np.shape(v)
            for p, v in flatten(numpy_tree(variables["params"])).items()}
    got = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == want
    assert tm.device == torch.device("cpu")


def test_load_model_builds_vicuna_with_jax_config():
    from vlm_compression_tpu.models import factory as JF

    tm = T.load_model(*VICUNA, tiny=True, device="cpu")
    _, want = JF.build_model_config({"arch": VICUNA[0],
                                     "model_type": VICUNA[1], "tiny": True})
    _same_fields(tm.cfg, want)
    assert tm.cfg.llm.hidden_size == 16


@pytest.mark.parametrize("arch,model_type", [ARCHS[0], VICUNA])
def test_load_model_reads_a_checkpoint(tmp_path, arch, model_type):
    """Weights saved by the port (the JAX model's, carried across, for
    InstructBLIP-T5; another seed's for Vicuna) come back bit for bit
    (strict keys)."""
    carried = T.load_model(arch, model_type, tiny=True, device="cpu",
                           seed=3)
    if (arch, model_type) in ARCHS:
        _, variables = J.load_model(arch, model_type, tiny=True, seed=3)
        load_jax_variables(carried, numpy_tree(
            {"params": variables["params"]}), strict=True)
    path = tmp_path / "ck.pt"
    torch.save(carried.state_dict(), path)
    tm = T.load_model(arch, model_type, tiny=True, device="cpu",
                      checkpoint=str(path))
    want = carried.state_dict()
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    seeded = T.load_model(arch, model_type, tiny=True, device="cpu")
    assert not all(torch.equal(seeded.state_dict()[k], want[k])
                   for k in want)


def test_loaders_want_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.load_model("blip2_t5_instruct", tiny=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.load_model_and_preprocess("blip2_t5_instruct", tiny=True)
    m = T.models.load_model("blip2_t5_instruct", tiny=True, device="cpu")
    assert m.device.type == "cpu"


def test_unbuilt_arch_raises_in_both():
    with pytest.raises(ValueError):
        J.load_model("blip2_opt", tiny=True)
    with pytest.raises(NotImplementedError, match="cannot build it either"):
        T.load_model("blip2_opt", tiny=True, device="cpu")


@pytest.mark.parametrize("arch,model_type", ARCHS)
def test_load_model_and_preprocess_matches_jax(arch, model_type):
    from PIL import Image

    _, _, jvis, jtxt = J.load_model_and_preprocess(arch, model_type,
                                                   tiny=True)
    tm, tvis, ttxt = T.load_model_and_preprocess(arch, model_type, tiny=True,
                                                 device="cpu")
    assert isinstance(tm, torch.nn.Module)
    assert set(tvis) == set(jvis) == set(ttxt) == set(jtxt) == {"train",
                                                                 "eval"}
    pixels = np.random.default_rng(9).integers(0, 256, (41, 53, 3),
                                               dtype=np.uint8)
    for split in ("train", "eval"):
        jp, tp = jvis[split], tvis[split]
        assert type(tp).__name__ == type(jp).__name__
        if split == "train":
            jp.rng, tp.rng = (np.random.default_rng(5),
                              np.random.default_rng(5))
        want = jp(Image.fromarray(pixels))
        got = tp(pixels)
        assert got.shape == (tm.cfg.vit.img_size,) * 2 + (3,)
        np.testing.assert_array_equal(got, want)
        caption = "  A Dog, running!  on the   GRASS. "
        assert ttxt[split](caption) == jtxt[split](caption)


def test_load_pruner_builds_jax_classes():
    names = T.registry.list_names("pruner")
    assert names == J.registry.list_names("pruner")
    for name in names:
        assert (T.registry.get_pruner_class(name).__name__
                == J.registry.get_pruner_class(name).__name__), name


def test_load_pruner_prunes_as_jax():
    """The package-level ``load_pruner`` on a tiny fp32 ViT: JAX's
    masks."""
    from test_torch_models import tiny_blip

    jm, variables, tm, _ = tiny_blip(seed=4, masks=False)
    params = numpy_tree(variables["params"])
    rng = np.random.default_rng(10)
    img = jm.cfg.vit.img_size
    batches = [{"image": rng.standard_normal((4, img, img, 3))
                .astype(np.float32)} for _ in range(2)]
    spec = dict(vit_prune_spec="2-0.5-1.0-1.0", num_samples=8)
    jres, _ = J.load_pruner(
        "vit_wanda_pruner",
        FlaxModel(JV.EvaViT(jm.cfg.vit),
                  _copy_spine({"params": params["visual_encoder"]})),
        [{"image": jnp.asarray(b["image"])} for b in batches],
        None, **spec).prune(lora_model=True)
    pruner = T.load_pruner("vit_wanda_pruner", tm.visual_encoder,
                           [{"image": torch.from_numpy(b["image"])}
                            for b in batches], None, **spec)
    assert type(pruner).__name__ == type(J.load_pruner(
        "vit_wanda_pruner", None, [], None, **spec)).__name__
    pruner.prune(lora_model=True)
    got = export_masks(tm.visual_encoder)
    want = {p[:-1]: m for p, m in flatten(
        numpy_tree(jres.variables)["masks"]).items()}
    assert set(got) == set(want) and want
    for path in want:
        np.testing.assert_array_equal(got[path], want[path])
