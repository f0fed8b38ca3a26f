"""Port towers vs the JAX package on the CPU at tiny fp32 widths: EVA ViT,
Q-Former, FlanT5 and the whole InstructBLIP-T5 forward, in ``dense`` and
``masked`` modes (random masks), with parameters shared through the weight
bridge.  Tolerance: atol = rtol = 1e-4 on logits and hidden states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlm_compression_tpu.models import blip2_t5_instruct as JB
from vlm_compression_tpu.models import eva_vit as JV
from vlm_compression_tpu.models import qformer as JQ
from vlm_compression_tpu.models import t5 as JT
from vlm_compression_tpu_torch.models import blip2_t5_instruct as TB
from vlm_compression_tpu_torch.models import eva_vit as TV
from vlm_compression_tpu_torch.models import qformer as TQ
from vlm_compression_tpu_torch.models import t5 as TT
from vlm_compression_tpu_torch.models.bridge import load_jax_variables

TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(param_dtype="float32", dtype="float32")


def port_config(jcfg, cls):
    """The port's config with the JAX config's shared fields."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in dataclasses.asdict(jcfg).items()
                  if k in names})


def tiny_blip_configs():
    jcfg = JB.Blip2T5InstructConfig.tiny(
        vit=JV.EvaViTConfig.tiny(**F32),
        qformer=JQ.QFormerConfig.tiny(dtype="float32"),
        t5=JT.T5Config.tiny(d_model=16, **F32))
    tcfg = TB.Blip2T5InstructConfig(
        vit=port_config(jcfg.vit, TV.EvaViTConfig),
        qformer=port_config(jcfg.qformer, TQ.QFormerConfig),
        t5=port_config(jcfg.t5, TT.T5Config))
    return jcfg, tcfg


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def random_masks(params, rng, density=0.6):
    """A keep-mask for every linear (every dict holding a 2-D kernel)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            if "kernel" in v and np.ndim(v["kernel"]) == 2:
                out[k] = {"mask": rng.random(np.shape(v["kernel"])) < density}
            else:
                sub = random_masks(v, rng, density)
                if sub:
                    out[k] = sub
    return out


def blip_batch(rng, cfg, b=2, txt=5, lbl=4):
    img = cfg.vit.img_size
    am = np.ones((b, txt), np.int32)
    am[0, -2:] = 0                               # a padded prompt
    qam = np.ones((b, txt), np.int32)
    qam[1, -1] = 0
    labels = rng.integers(2, cfg.t5.vocab_size, (b, lbl)).astype(np.int32)
    labels[1, -1] = -100
    return dict(
        image=rng.standard_normal((b, img, img, 3)).astype(np.float32),
        input_ids=rng.integers(2, cfg.t5.vocab_size, (b, txt)).astype(np.int32),
        attention_mask=am, labels=labels,
        qformer_input_ids=rng.integers(2, cfg.qformer.vocab_size,
                                       (b, txt)).astype(np.int32),
        qformer_attention_mask=qam)


def tiny_blip(seed=0, masks=True):
    """(jax module, jax variables as numpy, port module, batch)."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = tiny_blip_configs()
    batch = blip_batch(rng, jcfg)
    jm = JB.Blip2T5Instruct(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = numpy_tree(jm.init(jax.random.key(seed), **jb,
                                   vit_mode="dense", llm_mode="dense",
                                   qformer_mode="dense"))
    if masks:
        variables = dict(variables,
                         masks=random_masks(variables["params"], rng))
    tm = TB.Blip2T5Instruct(tcfg, device="cpu")
    load_jax_variables(tm, variables)
    return jm, variables, tm, batch


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_eva_vit_matches_jax(mode):
    rng = np.random.default_rng(1)
    jcfg = JV.EvaViTConfig.tiny(**F32)
    images = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    jm = JV.EvaViT(jcfg)
    variables = numpy_tree(jm.init(jax.random.key(1), jnp.asarray(images),
                                   mode="dense"))
    variables["masks"] = random_masks(variables["params"], rng)
    want = jm.apply(variables, jnp.asarray(images), mode=mode)
    tm = TV.EvaViT(port_config(jcfg, TV.EvaViTConfig), device="cpu")
    load_jax_variables(tm, variables)
    got = tm(_t(images), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_interpolate_pos_embed_matches_jax():
    rng = np.random.default_rng(2)
    pe = rng.standard_normal((1, 17, 8)).astype(np.float32)
    want = np.asarray(JV.interpolate_pos_embed(jnp.asarray(pe), 25))
    got = TV.interpolate_pos_embed(_t(pe), 25).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_qformer_matches_jax(mode):
    rng = np.random.default_rng(3)
    jcfg = JQ.QFormerConfig.tiny(dtype="float32")
    img = rng.standard_normal((2, 5, jcfg.encoder_width)).astype(np.float32)
    ids = rng.integers(1, jcfg.vocab_size, (2, 6)).astype(np.int32)
    tmask = np.ones((2, 6), np.int32)
    tmask[0, -2:] = 0
    jm = JQ.QFormer(jcfg)
    args = (jnp.asarray(img), jnp.asarray(ids), jnp.asarray(tmask))
    variables = numpy_tree(jm.init(jax.random.key(3), *args, mode="dense"))
    variables["masks"] = random_masks(variables["params"], rng)
    want = jm.apply(variables, *args, mode=mode)
    tm = TQ.QFormer(port_config(jcfg, TQ.QFormerConfig), device="cpu")
    load_jax_variables(tm, variables)
    got = tm(_t(img), _t(ids), _t(tmask), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_t5_matches_jax(mode):
    rng = np.random.default_rng(4)
    jcfg = JT.T5Config.tiny(**F32)
    ids = rng.integers(1, jcfg.vocab_size, (3, 7)).astype(np.int32)
    mask = np.ones((3, 7), np.int32)
    mask[1, -3:] = 0
    labels = rng.integers(1, jcfg.vocab_size, (3, 5)).astype(np.int32)
    labels[2, -2:] = -100
    jm = JT.T5ForConditionalGeneration(jcfg)
    variables = numpy_tree(jm.init(
        jax.random.key(4), jnp.asarray(ids), jnp.asarray(mask),
        JT.shift_right(jnp.asarray(np.maximum(labels, 0))), mode="dense"))
    variables["masks"] = random_masks(variables["params"], rng)
    want = jm.apply(variables, jnp.asarray(ids), jnp.asarray(mask),
                    labels=jnp.asarray(labels), mode=mode)
    tm = TT.T5ForConditionalGeneration(port_config(jcfg, TT.T5Config),
                                       device="cpu")
    load_jax_variables(tm, variables)
    got = tm(_t(ids), _t(mask), labels=_t(labels), mode=mode)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **TOL)


def test_t5_helpers_match_jax():
    rng = np.random.default_rng(5)
    rel = np.arange(-140, 141, dtype=np.int32)[None, :] \
        - np.arange(0, 3, dtype=np.int32)[:, None]
    for bidir in (True, False):
        want = np.asarray(JT.relative_position_bucket(
            jnp.asarray(rel), bidir, 32, 128))
        got = TT.relative_position_bucket(_t(rel), bidir, 32, 128).numpy()
        np.testing.assert_array_equal(got, want)
    labels = rng.integers(-1, 9, (2, 6)).astype(np.int32)
    labels[labels < 0] = -100
    np.testing.assert_array_equal(
        TT.shift_right(_t(labels), 0, 0).numpy(),
        np.asarray(JT.shift_right(jnp.asarray(labels), 0, 0)))
    am = np.array([[1, 1, 0], [1, 0, 0]], np.int32)
    np.testing.assert_array_equal(TT.extend_mask(_t(am)).numpy(),
                                  np.asarray(JT.extend_mask(jnp.asarray(am))))
    np.testing.assert_array_equal(TT.causal_mask(4, 6).numpy(),
                                  np.asarray(JT.causal_mask(4, 6)))


@pytest.mark.parametrize("vit_mode,llm_mode", [("dense", "dense"),
                                               ("masked", "masked"),
                                               ("dense", "masked")])
def test_blip2_t5_forward_matches_jax(vit_mode, llm_mode):
    jm, variables, tm, batch = tiny_blip(seed=6)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jm.apply(variables, **jb, vit_mode=vit_mode, llm_mode=llm_mode,
                    qformer_mode="masked")
    got = tm(**{k: _t(v) for k, v in batch.items()}, vit_mode=vit_mode,
             llm_mode=llm_mode, qformer_mode="masked")
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **TOL)


# ------------------------------------------------------------- SparseLoRA
# Tiny fp32 configs as tests/test_training.py lays them out (LoRA ranks
# 4 / 2 / 8 on V / Q / L), random masks, and lora_b set to seeded non-zero
# values in both packages so that the adapters' delta is exercised.

LORA_RANKS = dict(vit=4, qformer=2, t5=8)


def tiny_lora_configs():
    jcfg = JB.Blip2T5InstructConfig.tiny(
        vit=JV.EvaViTConfig.tiny(lora_rank=LORA_RANKS["vit"], **F32),
        qformer=JQ.QFormerConfig.tiny(lora_rank=LORA_RANKS["qformer"],
                                      dtype="float32"),
        t5=JT.T5Config.tiny(d_model=16, lora_rank=LORA_RANKS["t5"], **F32))
    tcfg = TB.Blip2T5InstructConfig(
        vit=port_config(jcfg.vit, TV.EvaViTConfig),
        qformer=port_config(jcfg.qformer, TQ.QFormerConfig),
        t5=port_config(jcfg.t5, TT.T5Config))
    return jcfg, tcfg


def seeded_lora(lora, rng, std=0.3):
    """The lora tree with every lora_b drawn from the seed."""
    out = {}
    for k, v in lora.items():
        if k == "lora_b":
            out[k] = (std * rng.standard_normal(np.shape(v))).astype(
                np.float32)
        elif isinstance(v, dict):
            out[k] = seeded_lora(v, rng, std)
        else:
            out[k] = v
    return out


def tiny_lora_blip(seed=0, b=2):
    """(jax module, jax variables (params, lora, masks) as numpy, port
    module, batch) for the tiny LoRA configuration."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = tiny_lora_configs()
    batch = blip_batch(rng, jcfg, b=b)
    jm = JB.Blip2T5Instruct(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = numpy_tree(jm.init(jax.random.key(seed), **jb,
                                   vit_mode="sparse_lora",
                                   llm_mode="sparse_lora",
                                   qformer_mode="sparse_lora"))
    variables = dict(params=variables["params"],
                     lora=seeded_lora(variables["lora"], rng),
                     masks=random_masks(variables["params"], rng))
    tm = TB.Blip2T5Instruct(tcfg, device="cpu")
    load_jax_variables(tm, variables)
    return jm, variables, tm, batch


@pytest.mark.parametrize("mode", ["sparse_lora", "lora"])
def test_blip2_t5_lora_modes_match_jax(mode):
    jm, variables, tm, batch = tiny_lora_blip(seed=7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jm.apply(variables, **jb, vit_mode=mode, llm_mode=mode,
                    qformer_mode=mode)
    got = tm(**{k: _t(v) for k, v in batch.items()}, vit_mode=mode,
             llm_mode=mode, qformer_mode=mode)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **TOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **TOL)


def test_sparse_linear_lora_without_mask_matches_jax():
    """A LoRA linear that holds no mask: x·W + s·(x·A)·B."""
    from vlm_compression_tpu.models.layers import SparseLinear as JSL
    from vlm_compression_tpu_torch.models.layers import SparseLinear as TSL

    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 12)).astype(np.float32)
    jl = JSL(10, lora_rank=4, lora_alpha=8.0)
    variables = numpy_tree(jl.init(jax.random.key(8), jnp.asarray(x),
                                   mode="sparse_lora"))
    variables = dict(params=variables["params"],
                     lora=seeded_lora(variables["lora"], rng))
    want = jl.apply(variables, jnp.asarray(x), mode="sparse_lora")
    tl = TSL(12, 10, lora_rank=4, lora_alpha=8.0)
    load_jax_variables(tl, variables)
    got = tl(_t(x), mode="sparse_lora")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_random_init_keeps_base_draws_and_inits_lora():
    """Adapters do not shift the seeded base weights; A is he-uniform and
    B zero."""
    from vlm_compression_tpu_torch.models.bridge import random_init_

    _, tcfg = tiny_lora_configs()
    _, plain = tiny_blip_configs()
    with_lora = random_init_(TB.Blip2T5Instruct(tcfg, device="cpu"), seed=3)
    without = random_init_(TB.Blip2T5Instruct(plain, device="cpu"), seed=3)
    base = dict(without.named_parameters())
    for name, p in with_lora.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "lora_b":
            assert not p.any()
        elif leaf == "lora_a":
            bound = (6.0 / p.shape[0]) ** 0.5
            assert p.abs().max() <= bound and p.abs().max() > 0.5 * bound
        else:
            assert torch.equal(p, base[name]), name
