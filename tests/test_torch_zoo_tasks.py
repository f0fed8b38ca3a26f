"""The legacy zoo's eval tasks and data in the port vs the JAX package on
the CPU: ``MultimodalClassificationTask`` (its class-name ranking on a
tiny float32 InstructBLIP-T5, the accuracy and the size accounting), the
classification, NLVR and visual-entailment items through the
``imagenet``, ``cifar100``, ``nlvr`` and ``snli_ve`` builders, and the
task's refusal of the zoo models the reference pairs it with but cannot
score.

Tolerances: predictions, accuracy, metrics and samples exact (images
bit-equal: both packages decode the same PNG, the port also its ``.npy``
twin).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import tiny_blip
from test_torch_zoo_models import init_zoo
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.datasets import builders as JB
from vlm_compression_tpu.datasets import tokenization as JTok
from vlm_compression_tpu.tasks import classification as JC
from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets import builders as TB
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.tasks import classification as TC

ROOT = Path(__file__).resolve().parents[1]
CLASSES = ["dog", "a red cat", "two small men", "grass", "blue street"]


@pytest.fixture(scope="module")
def pictures(tmp_path_factory):
    """Five RGB images as PNG and as .npy."""
    root = tmp_path_factory.mktemp("zoo_pictures")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(40, 30), (28, 28), (17, 60), (64, 48),
                                (33, 33)]):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(img).save(root / f"p{i}.png")
        np.save(root / f"p{i}.npy", img)
    return root


def _annotations(root: Path, kind: str, ext: str) -> str:
    if kind == "classification":
        anns = [{"image": f"p{i}{ext}", "label": (3 * i) % 5}
                for i in range(5)]
    elif kind == "nlvr":
        anns = [{"images": [f"p{i}{ext}", f"p{(i + 2) % 5}{ext}"],
                 "sentence": f"There are {i} dogs.",
                 "label": ("True", "False", "true", "FALSE", "x")[i]}
                for i in range(5)]
    else:
        anns = [{"image": f"p{i}{ext}", "sentence": f"A man sits {i}.",
                 "label": ("entailment", "Neutral", " contradiction ", 2,
                           1)[i]}
                for i in range(5)]
    path = root / f"{kind}{ext}.json"
    path.write_text(json.dumps(anns))
    return str(path)


def _builder_cfg(root, ann):
    return {"build_info": {"annotations": {"val": [ann], "test": [ann]},
                           "images": {"storage": str(root)}},
            "vis_processor": {"eval": {"name": "blip_image_eval",
                                       "image_size": 28}},
            "text_processor": {"eval": {"name": "blip_caption"}}}


@pytest.mark.parametrize("name,kind", [("imagenet", "classification"),
                                       ("cifar100", "classification"),
                                       ("nlvr", "nlvr"),
                                       ("snli_ve", "entailment")])
@pytest.mark.parametrize("ext", [".png", ".npy"])
def test_zoo_items_and_builders_match_jax(pictures, name, kind, ext):
    """Every sample of every split equal, key by key; the port reads the
    ``.npy`` twin of each PNG to the same sample."""
    jsets = JB.load_builder(name, _builder_cfg(
        pictures, _annotations(pictures, kind, ".png"))).build_datasets()
    tsets = TB.load_builder(name, _builder_cfg(
        pictures, _annotations(pictures, kind, ext))).build_datasets()
    assert set(tsets) == set(jsets) == {"val", "test"}
    for split, jds in jsets.items():
        tds = tsets[split]
        assert type(tds).__name__ == type(jds).__name__
        assert len(tds) == len(jds) == 5
        for i in range(5):
            want, got = jds[i], tds[i]
            assert set(got) == set(want)
            for key, w in want.items():
                if isinstance(w, np.ndarray):
                    assert got[key].dtype == w.dtype
                    np.testing.assert_array_equal(got[key], w)
                else:
                    assert got[key] == w, key
        got = tds.collater([tds[0], tds[3]])
        want = jds.collater([jds[0], jds[3]])
        assert set(got) == set(want)
        for key, w in want.items():
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(w))


def test_the_video_builders_still_raise_with_their_item():
    """The video builders are ported (their items are held against JAX's
    in test_torch_alpro.py and test_torch_gpt_dialogue.py): the same item
    classes as JAX's; ``msrvtt_qa`` runs through
    ``multimodal_classification`` as in JAX (which ranks with
    ``predict_class_t5`` alone, so ALPRO QA runs through direct calls)."""
    for name in ("msrvtt_qa", "avsd_dialogue"):
        got, want = TB.load_builder(name, {}), JB.load_builder(name, {})
        assert got.eval_dataset_cls.__name__ == \
            want.eval_dataset_cls.__name__


@pytest.fixture(scope="module")
def blip():
    return tiny_blip(seed=3)


def _samples(batch, labels):
    n = batch["image"].shape[0]
    return {"image": batch["image"],
            "text_input": ["what is this?", "a photo of"][:n],
            "instance_id": list(range(n)), "label": labels[:n]}


@pytest.mark.parametrize("labels", [["dog", "grass"], ["two small men",
                                                        "blue street"]])
def test_multimodal_classification_matches_jax(blip, labels, tmp_path):
    """Predictions (the class names ``predict_class_t5`` ranks first) and
    the accuracy with the size accounting equal, and the ``evaluate.txt``
    line."""
    jm, variables, tm, batch = blip
    samples = _samples(batch, labels)
    kw = dict(class_names=CLASSES, max_len=6)
    jtask = JC.MultimodalClassificationTask(
        tokenizer=JTok.SimpleTokenizer(96),
        qformer_tokenizer=JTok.SimpleTokenizer(64), **kw)
    ttask = registry.get_task_class("multimodal_classification").setup_task(
        None, tokenizer=TTok.SimpleTokenizer(96),
        qformer_tokenizer=TTok.SimpleTokenizer(64), **kw)
    want = jtask.valid_step(FlaxModel(jm, variables), samples)
    got = ttask.valid_step(tm, samples)
    assert got == want
    assert all(r["prediction"] in CLASSES for r in got)
    sizes = dict(orig_total_size=3.9e9, distilled_total_size=2.05e9)
    out = []
    for task, res, label in ((jtask, want, "jax"), (ttask, got, "port")):
        metrics = task.after_evaluation(
            res, split_name="val", result_dir=str(tmp_path / label / "r"),
            **sizes)
        out.append((metrics, (tmp_path / label / "evaluate.txt")
                    .read_text()))
    assert out[0] == out[1]
    assert out[1][0]["orig_size"] == "3.900 B"


def test_setup_task_reads_the_zoo_yamls():
    from vlm_compression_tpu_torch.common._yaml import safe_load

    for name in ("clip/exp_imnet_zs_eval", "clip/exp_cifar100_zs_eval",
                 "blip/eval/nlvr_eval"):
        cfg = safe_load((ROOT / f"configs/projects/{name}.yaml")
                        .read_text())
        task = registry.get_task_class(cfg["run"]["task"]).setup_task(cfg)
        assert isinstance(task, TC.MultimodalClassificationTask)
        assert task.class_names == [] and task.max_len == \
            JC.MultimodalClassificationTask().max_len


@pytest.mark.parametrize("arch", ["clip", "blip_nlvr",
                                  "albef_classification"])
def test_classification_refuses_the_models_jax_cannot_score(arch):
    """The reference's yamls pair the task with these models, which have no
    ``predict_class``: JAX's task fails on them, and the port says so."""
    jm, variables, tm = init_zoo(arch, seed=40)
    rng = np.random.default_rng(40)
    samples = {"image": rng.standard_normal((2, 28, 28, 3)).astype(
        np.float32), "text_input": ["a", "b"], "instance_id": [0, 1]}
    jtask = JC.MultimodalClassificationTask(
        tokenizer=JTok.SimpleTokenizer(64), class_names=CLASSES)
    with pytest.raises(Exception):
        jtask.valid_step(FlaxModel(jm, variables), samples)
    ttask = TC.MultimodalClassificationTask(
        tokenizer=TTok.SimpleTokenizer(64), class_names=CLASSES)
    with pytest.raises(NotImplementedError, match="predict_class_t5"):
        with torch.no_grad():
            ttask.valid_step(tm, samples)
