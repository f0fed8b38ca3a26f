"""The stage-1 BLIP-2 Q-Former and the retrieval eval in the port vs the JAX
package on the CPU, tiny fp32 widths, parameters (with random masks on
every linear) and inputs from a numpy seed carried across by the weight
bridge (``load_jax_variables``, strict).

Tolerances: hidden states, features, logits, losses and score matrices
atol = rtol = 1e-4 (as ``tests/test_torch_models.py``); the rerank's top-k
sets, the keep-masks of the ViT prune and every retrieval metric exact;
the ``evaluate.txt`` line equal; the factory's configs field for field.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_models import (
    F32,
    numpy_tree,
    port_config,
    random_masks,
)
from test_torch_pipeline import _copy_spine
from vlm_compression_tpu.common.registry import registry as jax_registry
from vlm_compression_tpu.compression import load_pruner as jax_load_pruner
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.datasets import tokenization as JTok
from vlm_compression_tpu.evaluation import retrieval_metrics as JRM
from vlm_compression_tpu.models import blip2_qformer as JBQ
from vlm_compression_tpu.models import eva_vit as JV
from vlm_compression_tpu.models import factory as JF
from vlm_compression_tpu.models import qformer as JQ
from vlm_compression_tpu.models.t5_plain import Blip2ITM as JBlip2ITM
from vlm_compression_tpu.tasks import retrieval as JR
from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.compression import load_pruner
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.evaluation import itm_eval
from vlm_compression_tpu_torch.models import blip2_qformer as TBQ
from vlm_compression_tpu_torch.models import eva_vit as TV
from vlm_compression_tpu_torch.models import factory as TF
from vlm_compression_tpu_torch.models import qformer as TQ
from vlm_compression_tpu_torch.models.bridge import (
    export_masks,
    flatten,
    load_jax_variables,
)
from vlm_compression_tpu_torch.tasks import retrieval as TR

TOL = dict(atol=1e-4, rtol=1e-4)
ROOT = Path(__file__).resolve().parents[1]
WORDS = ("a dog cat man woman red blue sits runs on the grass street "
         "near two small big").split()


def _configs():
    jcfg = JBQ.Blip2QformerConfig.tiny(
        vit=JV.EvaViTConfig.tiny(**F32),
        qformer=JQ.QFormerConfig.tiny(dtype="float32"))
    tcfg = TBQ.Blip2QformerConfig(
        vit=port_config(jcfg.vit, TV.EvaViTConfig),
        qformer=port_config(jcfg.qformer, TQ.QFormerConfig),
        embed_dim=jcfg.embed_dim, max_txt_len=jcfg.max_txt_len)
    return jcfg, tcfg


def _batch(rng, b=4, txt=6):
    mask = np.ones((b, txt), np.int32)
    mask[1, -2:] = 0                               # padded captions
    mask[3, -1:] = 0
    return dict(image=rng.standard_normal((b, 28, 28, 3)).astype(np.float32),
                text_ids=rng.integers(4, 60, (b, txt)).astype(np.int32),
                text_mask=mask)


@pytest.fixture(scope="module")
def tiny():
    """(jax module, its variables with masks as numpy, port module loaded
    from them, a batch): the JAX model is initialised once per module."""
    rng = np.random.default_rng(0)
    jcfg, tcfg = _configs()
    batch = _batch(rng)
    jm = JBQ.Blip2Qformer(jcfg)
    variables = numpy_tree(jm.init(
        jax.random.key(0), **{k: jnp.asarray(v) for k, v in batch.items()}))
    variables = dict(variables, masks=random_masks(variables["params"], rng))
    tm = TBQ.Blip2Qformer(tcfg, device="cpu")
    load_jax_variables(tm, variables, strict=True)
    return jm, variables, tm, batch


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def test_bridge_carries_every_leaf_and_temp(tiny):
    """strict load covers every parameter, the scalar ``temp`` included;
    the JAX init's temp is 0.07, as the port's ``random_init_`` gives."""
    _, variables, tm, _ = tiny
    assert float(tm.temp) == float(variables["params"]["temp"])
    assert tm.temp.shape == () and float(tm.temp) == np.float32(0.07)
    for head in ("vision_proj", "text_proj", "itm_head", "lm_head"):
        np.testing.assert_array_equal(
            getattr(tm, head).kernel.numpy(),
            variables["params"][head]["kernel"])
    model = TF.build_model(dict(arch="blip2", tiny=True), seed=1,
                           device="cpu")
    assert float(model.temp) == np.float32(0.07)
    assert float(model.ln_vision.scale.min()) == 1.0


@pytest.mark.parametrize("masked,causal", [(False, False), (True, False),
                                           (True, True)])
def test_qformer_forward_text_matches_jax(tiny, masked, causal):
    jm, variables, tm, batch = tiny
    mask = batch["text_mask"] if masked else None
    want = jm.apply(variables, jnp.asarray(batch["text_ids"]),
                    None if mask is None else jnp.asarray(mask),
                    method=lambda m, i, k: m.qformer.forward_text(
                        i, k, causal=causal, mode="masked"))
    got = tm.qformer.forward_text(_t(batch["text_ids"]),
                                  None if mask is None else _t(mask),
                                  causal=causal, mode="masked")
    _close(got, want)


@pytest.mark.parametrize("causal_text", [False, True])
def test_qformer_forward_multimodal_matches_jax(tiny, causal_text):
    jm, variables, tm, batch = tiny
    embeds = np.asarray(jm.apply(variables, jnp.asarray(batch["image"]),
                                 method=JBQ.Blip2Qformer.image_embeds))
    want = jm.apply(variables, jnp.asarray(embeds),
                    jnp.asarray(batch["text_ids"]),
                    jnp.asarray(batch["text_mask"]),
                    method=lambda m, e, i, k: m.qformer.forward_multimodal(
                        e, i, k, causal_text=causal_text, mode="masked"))
    got = tm.qformer.forward_multimodal(
        _t(embeds), _t(batch["text_ids"]), _t(batch["text_mask"]),
        causal_text=causal_text, mode="masked")
    _close(got, want)


@pytest.mark.parametrize("method", ["image_embeds", "forward_image",
                                    "forward_text", "itm_logits"])
@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_blip2_methods_match_jax(tiny, method, mode):
    jm, variables, tm, batch = tiny
    img, ids, mask = (batch[k] for k in ("image", "text_ids", "text_mask"))
    embeds = np.asarray(jm.apply(variables, jnp.asarray(img), mode,
                                 method=JBQ.Blip2Qformer.image_embeds))
    args = {"image_embeds": (img, mode), "forward_image": (img, mode, mode),
            "forward_text": (ids, mask, mode),
            "itm_logits": (embeds, ids, mask, mode)}[method]
    want = jm.apply(variables, *(jnp.asarray(a) if isinstance(a, np.ndarray)
                                 else a for a in args),
                    method=getattr(JBQ.Blip2Qformer, method))
    got = getattr(tm, method)(*(_t(a) if isinstance(a, np.ndarray) else a
                                for a in args))
    if method == "forward_image":
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


@pytest.mark.parametrize("mode", ["image", "text", "multimodal"])
def test_extract_features_matches_jax(tiny, mode):
    jm, variables, tm, batch = tiny
    want = jm.apply(variables, {k: jnp.asarray(v) for k, v in batch.items()},
                    mode, method=JBQ.Blip2Qformer.extract_features)
    got = tm.extract_features({k: _t(v) for k, v in batch.items()}, mode)
    assert set(got) == set(want)
    for key in want:
        assert (got[key] is None) == (want[key] is None), key
        if want[key] is not None:
            _close(got[key], want[key])


@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_stage1_losses_match_jax(tiny, mode):
    """ITC, ITM over the argmax hard negatives, the causal LM."""
    jm, variables, tm, batch = tiny
    want = jm.apply(variables, **{k: jnp.asarray(v) for k, v in
                                  batch.items()}, vit_mode=mode,
                    qformer_mode=mode)
    got = tm(**{k: _t(v) for k, v in batch.items()}, vit_mode=mode,
             qformer_mode=mode)
    assert set(got) == set(want) == {"loss", "loss_itc", "loss_itm",
                                     "loss_lm"}
    for key in want:
        _close(got[key], want[key])


@pytest.mark.parametrize("head", ["itm", "itc", "all"])
def test_blip2_itm_heads_match_jax(tiny, head):
    jm, variables, _, batch = tiny
    jcfg, tcfg = _configs()
    tm = TBQ.Blip2ITM(tcfg, device="cpu")
    load_jax_variables(tm, variables, strict=True)
    args = (batch["image"], batch["text_ids"], batch["text_mask"])
    want = JBlip2ITM(jcfg).apply(variables, *map(jnp.asarray, args),
                                 match_head=head)
    got = tm(*map(_t, args), match_head=head)
    if head != "all":
        got, want = {head: got}, {head: want}
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key])


def _retrieval_set(seed, n_img=6, per_image=2, batches=(4, 2)):
    """Images in ragged batches and ``per_image`` captions of 2-9 words an
    image (Flickr30k's layout at a tiny scale)."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n_img, 28, 28, 3)).astype(np.float32)
    text = [" ".join(rng.choice(WORDS, rng.integers(2, 10)))
            for _ in range(n_img * per_image)]
    cuts = np.cumsum((0,) + batches)
    return dict(images=[images[a:b] for a, b in zip(cuts[:-1], cuts[1:])],
                text=text, txt2img=[t // per_image for t in range(len(text))],
                img2txt={i: list(range(i * per_image, (i + 1) * per_image))
                         for i in range(n_img)})


def _top(score, k):
    return [set(np.argsort(-row)[:k].tolist()) for row in score]


@pytest.fixture(scope="module")
def sim_inputs(tiny):
    """The inputs of the sim-matrix test and JAX's ITC matrices on them
    (computed once: JAX runs them op by op)."""
    jm, variables, _, _ = tiny
    data = _retrieval_set(1)
    ids, mask = TTok.batch_encode(TTok.SimpleTokenizer(64), data["text"], 35)
    jitc = JBQ.compute_sim_matrix(
        jm, variables, [jnp.asarray(b) for b in data["images"]],
        jnp.asarray(ids), jnp.asarray(mask), text_batch=5)
    return data, ids, mask, [np.asarray(x) for x in jitc]


@pytest.mark.parametrize("k_test", [0, 2])
def test_compute_sim_matrix_matches_jax(tiny, sim_inputs, k_test):
    """Ragged image batches (4, 2), 12 captions in chunks of 5: the score
    matrices within the tolerance, the ITC top-k sets equal, and the
    reranked entries (those that left the ITC score) the same ones, k a
    row in each direction."""
    jm, variables, tm, _ = tiny
    data, ids, mask, jitc = sim_inputs
    want = jitc if not k_test else [np.asarray(x) for x in
                                    JBQ.compute_sim_matrix(
        jm, variables, [jnp.asarray(b) for b in data["images"]],
        jnp.asarray(ids), jnp.asarray(mask), k_test=k_test, text_batch=5)]
    got = TBQ.compute_sim_matrix(tm, data["images"], ids, mask,
                                 k_test=k_test, text_batch=5)
    itc = TBQ.compute_sim_matrix(tm, data["images"], ids, mask, text_batch=5)
    for g, w, s, js in zip(got, want, itc, jitc):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
        assert _top(s, 2) == _top(js, 2)
        moved = g != s
        np.testing.assert_array_equal(moved, w != js)
        assert (moved.sum(1) == (min(k_test, s.shape[1]) if k_test
                                 else 0)).all()
    if not k_test:
        np.testing.assert_array_equal(got[0], got[1].T)


class _Loader:
    """Batches of images, the dataset on ``.dataset``."""

    def __init__(self, data):
        self.dataset = type("RetrievalSet", (), dict(
            text=data["text"], txt2img=data["txt2img"],
            img2txt=data["img2txt"]))()
        self._images = data["images"]

    def __iter__(self):
        return iter({"image": b} for b in self._images)


def test_retrieval_task_matches_jax(tiny, tmp_path):
    """``evaluation`` + ``after_evaluation`` at k_test 2: the score
    matrices within the tolerance, the metrics dict and the
    ``evaluate.txt`` line equal."""
    jm, variables, tm, _ = tiny
    data = _retrieval_set(1)
    jtask = JR.RetrievalTask(k_test=2, tokenizer=JTok.SimpleTokenizer(64))
    ttask = TR.RetrievalTask(k_test=2, tokenizer=TTok.SimpleTokenizer(64))
    want = jtask.evaluation(FlaxModel(jm, variables), _Loader(data))
    got = ttask.evaluation(tm, _Loader(data))
    for key in ("score_i2t", "score_t2i"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), **TOL)
    assert got["txt2img"] == want["txt2img"]
    assert got["img2txt"] == want["img2txt"]
    lines = []
    for task, res, label in ((jtask, want, "jax"), (ttask, got, "port")):
        metrics = task.after_evaluation(
            res, split_name="test", result_dir=str(tmp_path / label / "res"))
        lines.append((metrics, (tmp_path / label / "evaluate.txt")
                      .read_text()))
    assert lines[0][0] == lines[1][0]
    assert lines[0][1] == lines[1][1] and lines[1][1].count("\n") == 1


@pytest.mark.parametrize("name", ["ret_flickr_eval", "ret_coco_eval"])
def test_setup_task_reads_the_eval_yamls(name):
    cfg = yaml.safe_load((ROOT / f"configs/projects/eval/{name}.yaml")
                         .read_text())
    jtask = JR.RetrievalTask.setup_task(
        type("Cfg", (), dict(run_cfg=cfg["run"]))())
    ttask = registry.get_task_class(cfg["run"]["task"]).setup_task(cfg)
    assert isinstance(ttask, TR.RetrievalTask)
    assert ttask.k_test == jtask.k_test == 128
    assert ttask.max_txt_len == jtask.max_txt_len == 35
    assert cfg["model"] == dict(arch="blip2", model_type="coco")


def test_registers_the_jax_task_names():
    for name in ("retrieval", "ret_flickr_eval", "ret_coco_eval"):
        assert jax_registry.get_task_class(name) is JR.RetrievalTask
        assert registry.get_task_class(name) is TR.RetrievalTask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_itm_eval_matches_jax_exactly(seed):
    """Random matrices with ties (scores rounded to one decimal), several
    captions per image: every metric equal."""
    rng = np.random.default_rng(seed)
    n_img, per = 9, 1 + seed
    n_txt = n_img * per + 2
    i2t = np.round(rng.standard_normal((n_img, n_txt)), 1).astype(np.float32)
    t2i = np.round(rng.standard_normal((n_txt, n_img)), 1).astype(np.float32)
    txt2img = [int(x) for x in rng.integers(0, n_img, n_txt)]
    img2txt = {i: sorted(set(rng.integers(0, n_txt, per).tolist()))
               for i in range(n_img)}
    want = JRM.itm_eval(i2t, t2i, txt2img, img2txt)
    got = itm_eval(i2t, t2i, txt2img, img2txt)
    assert got == want
    assert json.dumps(got) == json.dumps(want)


NOT_PORTED_KNOBS = set()


@pytest.mark.parametrize("arch", ["blip2", "blip2_feature_extractor",
                                  "blip2_image_text_matching"])
@pytest.mark.parametrize("node", [dict(model_type="pretrain"),
                                  dict(model_type="coco"),
                                  dict(model_type="coco", tiny=True)])
def test_factory_stage1_configs_match_jax(arch, node):
    jarch, jcfg = JF.build_model_config(dict(node, arch=arch))
    tarch, tcfg = TF.build_model_config(dict(node, arch=arch))
    assert jarch == tarch == arch
    t, j = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    assert set(t) == set(j) == {"vit", "qformer", "embed_dim", "max_txt_len"}
    for key, tv in t.items():
        if not isinstance(tv, dict):
            assert tv == j[key], key
            continue
        assert {f: j[key][f] for f in tv} == tv, key
        extra = set(j[key]) - set(tv)
        assert extra <= NOT_PORTED_KNOBS and not any(
            j[key][f] for f in extra), key
    if not node.get("tiny"):
        assert (tcfg.vit.depth, tcfg.vit.img_size, tcfg.qformer.hidden_size,
                tcfg.embed_dim) == (39, 224, 768, 256)
    model_cls = {"blip2_image_text_matching": TBQ.Blip2ITM}.get(
        arch, TBQ.Blip2Qformer)
    if node.get("tiny"):
        assert type(TF.build_model(dict(node, arch=arch),
                                   device="cpu")) is model_cls


def test_task_refuses_instructblip():
    """InstructBLIP has no retrieval head (the JAX task fails on it too):
    the port says so instead of scoring it."""
    tm = TF.build_model(dict(arch="blip2_t5_instruct", tiny=True),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="no retrieval head"):
        TR.RetrievalTask(k_test=2).evaluation(tm, _Loader(_retrieval_set(3)))


def test_stage1_model_needs_a_device_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TBQ.Blip2Qformer(TBQ.Blip2QformerConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.build_model(dict(arch="blip2_image_text_matching", tiny=True))
    model = TBQ.Blip2Qformer(TBQ.Blip2QformerConfig.tiny(), device="cpu")
    assert model.device == torch.device("cpu")


@pytest.mark.parametrize("lora_model", [True, False])
def test_vit_wanda_prunes_the_stage1_tower_as_jax_does(tiny, lora_model):
    """``vit_wanda_pruner`` on the stage-1 model's bare ViT, as the JAX
    package's ``ViTPrunerBase`` prunes an ``EvaViT``: the keep-masks (masks
    kept) or the zeroed kernels (``lora_model=False``, as
    ``cli/evaluate.py`` prunes) equal, and the pruned model's image
    features within the tolerance."""
    jm, variables, _, _ = tiny
    jcfg, tcfg = _configs()
    params = {k: v for k, v in variables["params"].items()}
    plain = dict(params=params)                 # no masks: dense start
    rng = np.random.default_rng(4)
    batches = [{"image": rng.standard_normal((4, 28, 28, 3))
                .astype(np.float32)} for _ in range(2)]
    spec = dict(vit_prune_spec="2-0.5-1.0-1.0", num_samples=8)
    jres, _ = jax_load_pruner(
        "vit_wanda_pruner",
        FlaxModel(JV.EvaViT(jcfg.vit),
                  _copy_spine({"params": params["visual_encoder"]})),
        [{"image": jnp.asarray(b["image"])} for b in batches],
        **spec).prune(lora_model=lora_model)
    tm = TBQ.Blip2Qformer(tcfg, device="cpu")
    load_jax_variables(tm, plain, strict=True)
    load_pruner("vit_wanda_pruner", tm.visual_encoder,
                [{"image": _t(b["image"])} for b in batches],
                **spec).prune(lora_model=lora_model)
    got = export_masks(tm.visual_encoder)
    jvars = numpy_tree(jres.variables)
    if lora_model:
        want = {path[:-1]: m for path, m in flatten(jvars["masks"]).items()}
        assert set(got) == set(want) and len(want) == 2 * 4
        for path in want:
            np.testing.assert_array_equal(got[path], want[path])
    else:
        assert not got and "masks" not in jvars
        for path, w in flatten(jvars["params"]).items():
            if path[-1] == "kernel" and np.ndim(w) == 2:
                k = tm.visual_encoder.get_submodule(".".join(path[:-1]))
                np.testing.assert_array_equal(k.kernel.numpy() == 0, w == 0)
    full = dict(params=dict(params, visual_encoder=jvars["params"]),
                **({"masks": {"visual_encoder": jvars["masks"]}}
                   if lora_model else {}))
    image = rng.standard_normal((3, 28, 28, 3)).astype(np.float32)
    want = jm.apply(full, jnp.asarray(image),
                    method=JBQ.Blip2Qformer.forward_image)
    for g, w in zip(tm.forward_image(_t(image)), want):
        _close(g, w)
