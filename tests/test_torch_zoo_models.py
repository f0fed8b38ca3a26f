"""The legacy image-text zoo in the port vs the JAX package on the CPU: the
plain ViT, MED (bidirectional and causal, with and without encoder
states), every BLIP-1, ALBEF, CLIP and EVA-CLIP head and the plain T5, at
tiny float32 widths.  Parameters come from JAX's own init (biases and
norm parameters then perturbed from a numpy seed, so that none is
trivially zero or one), with a random keep-mask on every linear for the
masked mode, and cross by the weight bridge with strict keys; inputs come
from the same numpy seed.

Tolerance: every output (hidden states, logits, losses, ITC features, ITM
logits, ``decode_step``, ``rank_answers``, ``predict``) within fp32
atol = rtol = 1e-5; predictions and the bridge's leaves exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import F32, numpy_tree, random_masks
from vlm_compression_tpu.models import albef as JA
from vlm_compression_tpu.models import blip1 as JB
from vlm_compression_tpu.models import clip_model as JC
from vlm_compression_tpu.models import eva_vit as JE
from vlm_compression_tpu.models import factory as JF
from vlm_compression_tpu.models import med as JM
from vlm_compression_tpu.models import t5 as JT
from vlm_compression_tpu.models import t5_plain as JP
from vlm_compression_tpu.models import vit as JV
from vlm_compression_tpu_torch.models import albef as TA
from vlm_compression_tpu_torch.models import alpro as TAL
from vlm_compression_tpu_torch.models import blip1 as TB
from vlm_compression_tpu_torch.models import clip_model as TC
from vlm_compression_tpu_torch.models import eva_vit as TE
from vlm_compression_tpu_torch.models import factory as TF
from vlm_compression_tpu_torch.models import med as TM
from vlm_compression_tpu_torch.models import pnp_vqa as TPN
from vlm_compression_tpu_torch.models import t5 as TT
from vlm_compression_tpu_torch.models import t5_plain as TP
from vlm_compression_tpu_torch.models import vit as TV
from vlm_compression_tpu_torch.models.bridge import (
    flatten,
    load_jax_variables,
)

TOL = dict(atol=1e-5, rtol=1e-5)
MODES = ("masked", "dense")

# JAX config class name → the port's
_PORT_CFG = {"ViTConfig": TV.ViTConfig, "MedConfig": TM.MedConfig,
             "Blip1Config": TB.Blip1Config, "AlbefConfig": TA.AlbefConfig,
             "ClipConfig": TC.ClipConfig, "ClipTextConfig": TC.ClipTextConfig,
             "EvaViTConfig": TE.EvaViTConfig, "T5Config": TT.T5Config,
             "PlainT5Config": TP.PlainT5Config,
             "AlproConfig": TAL.AlproConfig,
             "TimeSformerConfig": TAL.TimeSformerConfig,
             "PNPVQAConfig": TPN.PNPVQAConfig}


def to_port_config(jcfg):
    """The port's config of a JAX config, nested configs included (the
    fields both carry)."""
    cls = _PORT_CFG[type(jcfg).__name__]
    kw = {}
    for f in dataclasses.fields(cls):
        v = getattr(jcfg, f.name)
        kw[f.name] = to_port_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


def zoo_config(arch: str, **kw):
    """JAX's tiny float32 config of a zoo arch."""
    vit = JV.ViTConfig.tiny(**F32)
    if arch.startswith("blip_"):
        return JB.Blip1Config.tiny(vit=vit, med=JM.MedConfig.tiny(**F32),
                                   **kw)
    if arch.startswith("albef_"):
        return JA.AlbefConfig.tiny(
            vit=vit, med=JM.MedConfig.tiny(fusion_start=1, **F32), **kw)
    text = JC.ClipTextConfig.tiny(**F32)
    if arch.startswith("eva_clip"):
        return JC.ClipConfig.tiny_eva(eva=JE.EvaViTConfig.tiny(**F32),
                                      vit=vit, text=text)
    if arch.startswith("clip"):
        return JC.ClipConfig.tiny(vit=vit, text=text)
    return JP.PlainT5Config(t5=JT.T5Config.tiny(**F32))


def jax_class(arch):
    from vlm_compression_tpu.common.registry import registry
    from vlm_compression_tpu.models import _ensure_zoo_imported

    _ensure_zoo_imported()
    return registry.get_model_class(arch)


def perturb(params, rng, scale=0.1):
    """Biases and norm parameters moved off their init (zeros, ones)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = perturb(v, rng, scale)
        elif k in ("bias", "scale", "cls_token", "q_bias", "v_bias"):
            out[k] = (np.asarray(v) + scale * rng.standard_normal(
                np.shape(v))).astype(np.asarray(v).dtype)
        else:
            out[k] = v
    return out


def init_zoo(arch: str, seed: int = 0, masks: bool = True, **kw):
    """(jax module, numpy variables, port module loaded from them)."""
    rng = np.random.default_rng(seed)
    jcfg = zoo_config(arch, **kw)
    jm = jax_class(arch)(jcfg)
    batch = JF._legacy_example_batch(arch, jcfg, batch=2)
    variables = numpy_tree(dict(jm.init(jax.random.key(seed), **batch)))
    variables["params"] = perturb(variables["params"], rng)
    if masks:
        variables["masks"] = random_masks(variables["params"], rng)
    else:
        variables.pop("masks", None)
    tm = TF._MODELS[arch](to_port_config(jcfg), device="cpu")
    load_jax_variables(tm, variables, strict=True)
    return jm, variables, tm


def images(rng, b, size=28):
    return rng.standard_normal((b, size, size, 3)).astype(np.float32)


def text(rng, b, n, vocab=64, pad=True):
    ids = rng.integers(1, vocab, (b, n)).astype(np.int32)
    mask = np.ones((b, n), np.int32)
    if pad:
        mask[0, -2:] = 0
        mask[-1, -1:] = 0
    return ids, mask


def _t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], **tol)
        return
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **(tol or TOL))


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def japply(jm, variables, *args, method=None, **kw):
    args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    out = jm.apply(variables, *args, method=method, **kw)
    return jax.tree_util.tree_map(np.asarray, out)


def tapply(fn, *args, **kw):
    args = [_t(a) if isinstance(a, np.ndarray) else a for a in args]
    kw = {k: _t(v) if isinstance(v, np.ndarray) else v
          for k, v in kw.items()}
    return fn(*args, **kw)


# ------------------------------------------------------------ the towers


@pytest.mark.parametrize("mode", MODES)
def test_plain_vit_matches_jax(mode):
    rng = np.random.default_rng(1)
    jcfg = JV.ViTConfig.tiny(**F32)
    jm = JV.ViT(jcfg)
    img = images(rng, 3)
    variables = numpy_tree(dict(jm.init(jax.random.key(1), jnp.asarray(img))))
    variables["params"] = perturb(variables["params"], rng)
    variables["masks"] = random_masks(variables["params"], rng)
    tm = TV.ViT(to_port_config(jcfg), device="cpu")
    load_jax_variables(tm, variables, strict=True)
    close(tm(_t(img), mode=mode), japply(jm, variables, img, mode=mode))


def test_plain_vit_same_padding_matches_flax_conv():
    """A size that is no multiple of the patch: Flax's SAME padding."""
    rng = np.random.default_rng(2)
    jcfg = JV.ViTConfig.tiny(img_size=28, **F32)
    img = images(rng, 2, size=27)
    jm = JV.ViT(jcfg)
    variables = numpy_tree(dict(jm.init(jax.random.key(2),
                                        jnp.asarray(images(rng, 1)))))
    variables["params"] = perturb(variables["params"], rng)
    tm = TV.ViT(to_port_config(jcfg), device="cpu")
    load_jax_variables(tm, variables, strict=True)
    close(tm(_t(img), mode="dense"), japply(jm, variables, img, mode="dense"))


@pytest.fixture(scope="module")
def med():
    """JAX MED with cross-attention in its second layer, as ALBEF's."""
    rng = np.random.default_rng(3)
    jcfg = JM.MedConfig.tiny(fusion_start=1, **F32)
    jm = JM.MedBert(jcfg)
    ids, mask = text(rng, 3, 7)
    enc = rng.standard_normal((3, 5, 16)).astype(np.float32)

    def init(m, ids, mask, enc):
        return m.lm_logits(m(ids, mask, enc, jnp.ones(enc.shape[:2])))

    variables = numpy_tree(dict(jm.init(
        jax.random.key(3), jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(enc), method=init)))
    variables["params"] = perturb(variables["params"], rng)
    variables["masks"] = random_masks(variables["params"], rng)
    tm = TM.MedBert(to_port_config(jcfg), lm_head=True, device="cpu")
    load_jax_variables(tm, variables, strict=True)
    return jm, variables, tm, rng


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("states", ["none", "all_ones", "ragged"])
def test_med_matches_jax(med, mode, causal, states):
    jm, variables, tm, _ = med
    rng = np.random.default_rng(4)
    ids, mask = text(rng, 3, 7)
    enc = emask = None
    if states != "none":
        enc = rng.standard_normal((3, 5, 16)).astype(np.float32)
        emask = np.ones((3, 5), np.int32)
        if states == "ragged":
            emask[1, -2:] = 0
    want = japply(jm, variables, ids, mask, enc, emask, causal=causal,
                  mode=mode)
    got = tapply(tm, ids, mask, enc, emask, causal=causal, mode=mode)
    close(got, want)

    def head(m, h):
        return m.lm_logits(h, mode=mode)

    close(tm.lm_logits(got, mode=mode),
          japply(jm, variables, jnp.asarray(want), method=head))


def test_med_without_a_mask_and_from_a_start_layer_matches_jax(med):
    jm, variables, tm, _ = med
    rng = np.random.default_rng(5)
    ids, _ = text(rng, 2, 6)
    enc = rng.standard_normal((2, 4, 16)).astype(np.float32)
    close(tapply(tm, ids, None, enc, None),
          japply(jm, variables, ids, None, enc, None))
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    close(tapply(tm, inputs_embeds=x, encoder_hidden_states=enc,
                 start_layer=1),
          japply(jm, variables, inputs_embeds=x, encoder_hidden_states=enc,
                 start_layer=1))


def test_lm_loss_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 6)).astype(np.int32)
    labels[1, -2:] = -100
    lmask = (labels >= 0).astype(np.int32)
    lmask[0, :2] = 0
    for m in (None, lmask):
        want = JM.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                          None if m is None else jnp.asarray(m))
        got = TM.lm_loss(_t(logits), _t(labels), None if m is None else _t(m))
        close(got, want)


# ------------------------------------------------------------ BLIP-1, ALBEF


def vl_batch(rng, b=3, n=6):
    ids, mask = text(rng, b, n)
    return dict(image=images(rng, b), input_ids=ids, attention_mask=mask)


BLIP = sorted(TB.BLIP1_MODELS)
ALBEF = sorted(TA.ALBEF_MODELS)


@pytest.fixture(scope="module")
def zoo_models():
    cache = {}

    def get(arch, masks=True):
        if (arch, masks) not in cache:
            cache[arch, masks] = init_zoo(arch, seed=len(cache) + 10,
                                          masks=masks)
        return cache[arch, masks]

    return get


def _forward_cases(arch, rng):
    """(args, kwargs) of each forward the arch's head takes."""
    bt = vl_batch(rng)
    lbl_ids = bt["input_ids"].copy()
    lbl_ids[1, -1] = -100
    if arch.endswith("_nlvr"):
        return [dict(image0=bt["image"], image1=images(rng, 3),
                     input_ids=bt["input_ids"],
                     attention_mask=bt["attention_mask"],
                     labels=np.array([0, 1, 1], np.int32))]
    if arch.endswith("_classification"):
        return [dict(bt, labels=np.array([1, 0, 1], np.int32)), dict(bt)]
    if arch.endswith("_feature_extractor"):
        return [dict(bt, extract_mode=m)
                for m in ("image", "text", "multimodal")]
    if arch == "blip_image_text_matching":
        return [dict(bt, match_head=h) for h in ("itm", "itc")]
    if arch in ("blip_caption", "blip_pretrain"):
        return [dict(bt, labels=lbl_ids)]
    # the VQA heads decode their labels as ids: no -100 there
    if arch == "albef_vqa":
        return [dict(bt, labels=bt["input_ids"])]
    if arch == "blip_vqa":
        a_ids, a_mask = text(rng, 3, 4)
        return [dict(bt, labels=bt["input_ids"]),
                dict(bt, answer_ids=a_ids, answer_mask=a_mask)]
    if arch == "albef_pretrain":
        mlm = bt["input_ids"].copy()
        mlm[:, 2] = 3
        lbl = np.full_like(mlm, -100)
        lbl[:, 2] = bt["input_ids"][:, 2]
        return [dict(bt, mlm_input_ids=mlm, mlm_labels=lbl), dict(bt)]
    return [dict(bt)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", BLIP + ALBEF)
def test_zoo_head_forward_matches_jax(zoo_models, arch, mode):
    jm, variables, tm = zoo_models(arch, masks=mode == "masked")
    rng = np.random.default_rng(7)
    for kw in _forward_cases(arch, rng):
        close(tapply(tm, **kw, mode=mode),
              japply(jm, variables, **kw, mode=mode))


@pytest.mark.parametrize("arch", BLIP + ALBEF)
def test_zoo_bridge_builds_the_jax_tree_leaf_for_leaf(zoo_models, arch):
    """Each head builds only what its JAX init created; every parameter
    and mask is carried bit for bit; ``temp`` is 0.07 at init."""
    _, variables, tm = zoo_models(arch)
    params = {".".join(p): v for p, v in flatten(variables["params"]).items()}
    named = dict(tm.named_parameters())
    assert set(named) == set(params)
    for name, v in params.items():
        np.testing.assert_array_equal(named[name].numpy(), v)
    masks = {".".join(p[:-1]): v
             for p, v in flatten(variables["masks"]).items()}
    got = {n: m.mask.numpy() for n, m in tm.named_modules()
           if getattr(m, "mask", None) is not None}
    assert set(got) == set(masks)
    for name, v in masks.items():
        np.testing.assert_array_equal(got[name], v)
    assert float(TF.build_model(dict(arch=arch, tiny=True),
                                device="cpu").temp) == np.float32(0.07)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["blip_retrieval", "albef_retrieval"])
def test_itc_features_and_itm_logits_match_jax(zoo_models, arch, mode):
    jm, variables, tm = zoo_models(arch, masks=mode == "masked")
    bt = vl_batch(np.random.default_rng(8))
    albef = arch.startswith("albef")

    def feats(m, image, ids, mask):
        return m.itc_feats(image, ids, mask, mode=mode)

    want = japply(jm, variables, bt["image"], bt["input_ids"],
                  bt["attention_mask"], method=feats)
    got = tapply(tm.itc_feats, bt["image"], bt["input_ids"],
                 bt["attention_mask"], mode=mode)
    for g, w in zip(got, want):
        close(g, w)
    text_arg = got[3] if albef else _t(bt["input_ids"])

    def itm(m, t, mask, img):
        return m.itm_logits(t, mask, img, mode=mode)

    close(tm.itm_logits(text_arg, _t(bt["attention_mask"]), got[2],
                        mode=mode),
          japply(jm, variables, jnp.asarray(text_arg.numpy()),
                 bt["attention_mask"], jnp.asarray(got[2].numpy()),
                 method=itm))


@pytest.mark.parametrize("mode", MODES)
def test_blip_caption_decode_step_matches_jax(zoo_models, mode):
    jm, variables, tm = zoo_models("blip_caption", masks=mode == "masked")
    rng = np.random.default_rng(9)
    emb = rng.standard_normal((2, 5, 16)).astype(np.float32)
    ids, mask = text(rng, 2, 4)

    def step(m, e, s, sm):
        return m.decode_step(e, s, sm, mode=mode)

    close(tapply(tm.decode_step, emb, ids, mask, mode=mode),
          japply(jm, variables, emb, ids, mask, method=step))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["blip_vqa", "albef_vqa"])
def test_vqa_question_states_and_rank_answers_match_jax(zoo_models, arch,
                                                        mode):
    jm, variables, tm = zoo_models(arch, masks=mode == "masked")
    rng = np.random.default_rng(10)
    bt = vl_batch(rng, b=2)
    cand, cmask = text(rng, 4, 3)

    def rank(m, *a):
        return m.rank_answers(*a, mode=mode)

    args = (bt["image"], bt["input_ids"], bt["attention_mask"], cand, cmask)
    got = tapply(tm.rank_answers, *args, mode=mode)
    assert tuple(got.shape) == (2, 4)
    close(got, japply(jm, variables, *args, method=rank))

    def states(m, *a):
        return m.question_states(*a, mode=mode)

    close(tapply(tm.question_states, *args[:3], mode=mode),
          japply(jm, variables, *args[:3], method=states))


@pytest.mark.parametrize("arch", ["blip_classification",
                                  "albef_classification"])
def test_classification_predict_matches_jax(arch):
    jm, variables, tm = init_zoo(arch, seed=11, num_classes=5)
    bt = vl_batch(np.random.default_rng(11))

    def predict(m, *a):
        return m.predict(*a)

    want = japply(jm, variables, bt["image"], bt["input_ids"],
                  bt["attention_mask"], method=predict)
    got = tapply(tm.predict, bt["image"], bt["input_ids"],
                 bt["attention_mask"])
    assert tuple(got["logits"].shape) == (3, 5)
    close(got, want)


# ------------------------------------------------------------ CLIP, plain T5


def clip_ids(rng, b=3, n=7):
    ids = rng.integers(1, 60, (b, n)).astype(np.int32)
    ids[0, 4] = 63                      # an end-of-text token mid-sequence
    ids[1, 2] = ids[1, 5] = 62          # a tie: the first one pools
    return ids


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ["clip", "eva_clip"])
def test_clip_matches_jax(arch, mode):
    jm, variables, tm = init_zoo(arch, seed=12, masks=mode == "masked")
    rng = np.random.default_rng(12)
    img, ids = images(rng, 3), clip_ids(rng)
    close(tapply(tm, img, ids, mode=mode),
          japply(jm, variables, img, ids, mode=mode))

    def extract(m, *a):
        return m.extract_features(*a, mode=mode)

    close(tapply(tm.extract_features, img, ids, mode=mode),
          japply(jm, variables, img, ids, method=extract))

    def text_enc(m, t):
        return m.text(t, mode=mode)

    close(tapply(tm.text, ids, mode=mode),
          japply(jm, variables, ids, method=text_enc))


def test_clip_leaves_cross_bit_for_bit():
    _, variables, tm = init_zoo("eva_clip_feature_extractor", seed=13)
    params = {".".join(p): v for p, v in flatten(variables["params"]).items()}
    assert set(dict(tm.named_parameters())) == set(params)
    assert isinstance(tm.visual, TE.EvaViT)
    np.testing.assert_array_equal(tm.logit_scale.numpy(),
                                  params["logit_scale"])
    built = TF.build_model(dict(arch="clip", tiny=True), device="cpu")
    assert float(built.logit_scale) == pytest.approx(np.log(1 / 0.07),
                                                     rel=1e-7)


@pytest.mark.parametrize("mode", MODES)
def test_plain_t5_matches_jax(mode):
    jm, variables, tm = init_zoo("t5", seed=14, masks=mode == "masked")
    rng = np.random.default_rng(14)
    ids, mask = text(rng, 2, 6, vocab=96)
    labels = rng.integers(1, 96, (2, 4)).astype(np.int32)
    labels[0, -1] = -100
    close(tapply(tm, ids, mask, labels, mode=mode),
          japply(jm, variables, ids, mask, labels, mode=mode))
    dec, dmask = text(rng, 2, 3, vocab=96)
    close(tapply(tm.t5_model, ids, mask, dec, dmask, mode=mode),
          japply(jm, variables, ids, mask, dec, dmask, mode=mode,
                 method=lambda m, *a, **k: m.t5_model(*a, **k)))


# ------------------------------------------------------------ the factory


ZOO_ARCHS = BLIP + ALBEF + sorted(TC.CLIP_MODELS) + ["t5"]


@pytest.mark.parametrize("arch", ZOO_ARCHS)
@pytest.mark.parametrize("node", [dict(model_type="base"),
                                  dict(model_type="large", num_classes=7),
                                  dict(tiny=True, num_classes=3)])
def test_factory_zoo_configs_match_jax(arch, node):
    jarch, jcfg = JF.build_model_config(dict(node, arch=arch))
    tarch, tcfg = TF.build_model_config(dict(node, arch=arch))
    assert jarch == tarch == arch
    assert tcfg == to_port_config(jcfg)


@pytest.mark.parametrize("arch", ["blip_retrieval", "clip", "eva_clip"])
def test_factory_ignores_the_yaml_image_size_as_jax_does(arch):
    """Only ``num_classes`` is read from the model node: a yaml's 384 (or
    CLIP's ViT-L-14-336) still builds the 224 tower, in both packages."""
    node = dict(arch=arch, model_type="ViT-L-14-336", image_size=384)
    _, jcfg = JF.build_model_config(node)
    _, tcfg = TF.build_model_config(node)
    tower = tcfg.eva if getattr(tcfg, "use_eva", False) else tcfg.vit
    assert tower.img_size == 224 and tcfg == to_port_config(jcfg)


@pytest.mark.parametrize("arch", ["alpro_retrieval", "alpro_qa",
                                  "gpt_dialogue", "pnp_vqa",
                                  "img2prompt_vqa", "pnp_unifiedqav2_fid"])
def test_factory_unported_zoo_archs_raise_with_their_item(arch):
    """The archs that waited for the rest of the zoo are ported: the
    factory builds JAX's config for each (compared field by field, nested
    configs included) and the model its registry names."""
    import dataclasses

    from vlm_compression_tpu.common.registry import registry

    for node in (dict(tiny=True), dict(model_type="base")):
        _, jcfg = JF.build_model_config(dict(node, arch=arch))
        _, tcfg = TF.build_model_config(dict(node, arch=arch))
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert TF._MODELS[arch].__name__ == \
        registry.get_model_class(arch).__name__
