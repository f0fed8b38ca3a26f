"""GPT dialogue on AVSD in the port vs the JAX package on the CPU: the
model's logits and losses with and without the video prefix, token-type
ids sharing ``wte``, the ``gpt_dialogue`` and ``gpt_video_ft`` processors,
the ``avsd_dialogue`` builder and its items, ``DialogueTask``'s metric,
and ``cli.evaluate`` on dialogue_avsd_eval.yaml (which fails in both
packages, the same way), at tiny float32 widths (parameters from JAX's
init, perturbed and masked from a numpy seed, crossed by the bridge).

Tolerances: logits and losses within fp32 atol = rtol = 1e-5; the task's
metric within 1e-5; processors and items exact.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_torch_models import F32, numpy_tree, random_masks
from test_torch_zoo_models import close, japply, perturb, tapply
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.datasets import builders as JB
from vlm_compression_tpu.datasets import processors as JP
from vlm_compression_tpu.datasets import tokenization as JTok
from vlm_compression_tpu.models import gpt_dialogue as JG
from vlm_compression_tpu.tasks import dialogue_rc as JD
from vlm_compression_tpu_torch.cli import evaluate as TE
from vlm_compression_tpu_torch.datasets import builders as TB
from vlm_compression_tpu_torch.datasets import processors as TP
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.models import factory as TF
from vlm_compression_tpu_torch.models import gpt_dialogue as TG
from vlm_compression_tpu_torch.models.bridge import (
    flatten,
    load_jax_variables,
)
from vlm_compression_tpu_torch.tasks import dialogue_rc as TD

MODES = ("masked", "dense")
ROOT = Path(__file__).resolve().parents[1]
AVSD_YAML = ROOT / "configs/projects/gpt/eval/dialogue_avsd_eval.yaml"
WORDS = "what is the man doing he sits on a chair and reads book".split()


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def init_gpt(seed, masks=True):
    rng = np.random.default_rng(seed)
    jcfg = JG.GPTDialogueConfig.tiny(**F32)
    jm = JG.GPTDialogue(jcfg)
    from vlm_compression_tpu.models import factory as JF

    batch = JF._legacy_example_batch("gpt_dialogue", jcfg, batch=2)
    variables = numpy_tree(dict(jm.init(jax.random.key(seed), **batch)))
    variables.pop("calib", None)
    variables["params"] = perturb(variables["params"], rng)
    if masks:
        variables["masks"] = random_masks(variables["params"], rng)
    else:
        variables.pop("masks", None)
    tcfg = TG.GPTDialogueConfig(**{f: getattr(jcfg, f) for f in
                                   TG.GPTDialogueConfig.__dataclass_fields__})
    tm = TG.GPTDialogue(tcfg, device="cpu")
    load_jax_variables(tm, variables, strict=True)
    return jm, variables, tm


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(masks=True):
        if masks not in cache:
            cache[masks] = init_gpt(50 + len(cache), masks)
        return cache[masks]

    return get


def dialogue_batch(rng, b=3, n=9, n_vid=4):
    ids = rng.integers(1, 59, (b, n)).astype(np.int32)
    types = rng.integers(59, 64, (b, n)).astype(np.int32)
    labels = ids.copy()
    labels[:, : n // 2] = -1
    labels[0, -2:] = -1
    fts = rng.standard_normal((b, n_vid, 8)).astype(np.float32)
    return dict(input_ids=ids, token_type_ids=types, labels=labels,
                video_fts=fts)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("video", [True, False])
@pytest.mark.parametrize("types", [True, False])
def test_gpt_dialogue_matches_jax(models, mode, video, types):
    jm, variables, tm = models(masks=mode == "masked")
    bt = dialogue_batch(np.random.default_rng(1))
    if not video:
        bt.pop("video_fts")
    if not types:
        bt.pop("token_type_ids")
    for kw in (bt, {k: v for k, v in bt.items() if k != "labels"}):
        want = japply(jm, variables, **kw, mode=mode)
        got = tapply(tm, **kw, mode=mode)
        close(got, want)
        if video and "labels" in kw:
            assert float(got["video_loss"]) > 0


def test_gpt_bridge_builds_the_jax_tree_leaf_for_leaf(models):
    _, variables, tm = models()
    params = {".".join(p): v for p, v in flatten(variables["params"]).items()}
    assert set(dict(tm.named_parameters())) == set(params)
    built = TF.build_model(dict(arch="gpt_dialogue", tiny=True),
                           device="cpu")
    assert tuple(built.video_ff.kernel.shape) == (8, 16)
    assert set(dict(built.named_parameters())) == set(params)


def test_factory_gpt_config_matches_jax():
    from vlm_compression_tpu.models import factory as JF

    for node in (dict(model_type="base"), dict(tiny=True)):
        _, jcfg = JF.build_model_config(dict(node, arch="gpt_dialogue"))
        _, tcfg = TF.build_model_config(dict(node, arch="gpt_dialogue"))
        assert dataclass_dict(tcfg) == dataclass_dict(jcfg)
    assert (tcfg.n_layer, tcfg.len_video_ft) == (2, 8)


def dataclass_dict(cfg):
    import dataclasses

    return dataclasses.asdict(cfg)


# ------------------------------------------------------------ data


def avsd_annotation(rng, i):
    def words(k):
        return " ".join(rng.choice(WORDS, k))

    return {"video": f"v{i}", "caption": words(4), "summary": words(3),
            "dialog": [{"question": words(3), "answer": words(2)}
                       for _ in range(i % 4 + 1)],
            "question": words(4), "answer": words(3)}


@pytest.mark.parametrize("kw", [{}, {"max_turns": 1},
                                {"use_caption": False, "max_turns": 2}])
def test_gpt_dialogue_processor_equals_jax(kw):
    rng = np.random.default_rng(2)
    jp = JP.GPTDialogueProcessor(tokenizer=JTok.SimpleTokenizer(60), **kw)
    tp = TP.GPTDialogueProcessor(tokenizer=TTok.SimpleTokenizer(60), **kw)
    assert (tp.bos, tp.cap) == (jp.bos, jp.cap) == (60, 64)
    for i in range(4):
        ann = avsd_annotation(rng, i)
        want, got = jp(ann), tp(ann)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    default = TP.load_processor("gpt_dialogue", {"max_turns": 2})
    assert default.max_turns == 2 and default.bos == 8192


def test_gpt_video_ft_processor_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    for name, (t, d) in {"i3d_rgb": (6, 5), "i3d_flow": (7, 5),
                         "vggish": (5, 3)}.items():
        (tmp_path / name).mkdir()
        np.save(tmp_path / name / "clip.npy",
                rng.standard_normal((t, d)).astype(np.float64))
    cfg = {"visual_ft": ["i3d_flow", "i3d_rgb"], "audio_ft": ["vggish"]}
    want = JP.load_processor("gpt_video_ft", cfg)(str(tmp_path), "clip")
    got = TP.load_processor("gpt_video_ft", cfg)(str(tmp_path), "clip")
    assert got["video_fts"].shape == (5, 13)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def avsd_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("avsd")
    rng = np.random.default_rng(4)
    anns = []
    for i in range(3):
        np.save(root / f"{i}.npy", rng.integers(0, 256, (4, 18, 20, 3),
                                                dtype=np.uint8))
        ann = avsd_annotation(rng, i)
        ann["video"] = f"{i}.npy"
        anns.append(ann)
    path = root / "ann.json"
    path.write_text(json.dumps(anns))
    return root, str(path)


def _avsd_cfg(root, ann, vis, txt):
    return {"build_info": {"annotations": {"test": [ann]},
                           "images": {"storage": str(root)}},
            "vis_processor": {"eval": vis}, "text_processor": {"eval": txt}}


def test_avsd_builder_items_equal_jax(avsd_files):
    """With an image and a caption processor the items build in both
    packages, sample for sample: the dialogue history as ``text_input``,
    the answer as ``text_output``, the frames subsampled to 4."""
    root, ann = avsd_files
    cfg = _avsd_cfg(root, ann, {"name": "blip_image_eval", "image_size": 12},
                    {"name": "blip_caption"})
    jds = JB.load_builder("avsd_dialogue", cfg).build_datasets()["test"]
    tds = TB.load_builder("avsd_dialogue", cfg).build_datasets()["test"]
    assert type(tds).__name__ == type(jds).__name__ == "VideoDialogueDataset"
    for i in range(3):
        want, got = jds[i], tds[i]
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got["image"].shape == (4, 12, 12, 3)
        for k in ("text_input", "text_output", "instance_id"):
            assert got[k] == want[k]


def test_avsd_builder_with_the_yaml_processors_fails_in_both(avsd_files):
    """The yaml's processors do not fit the items, in the JAX package as
    in the port: ``gpt_video_ft`` takes (ft_root, vname) where the item
    passes one frame, and ``gpt_dialogue`` an annotation where the item
    passes the history string."""
    root, ann = avsd_files
    vis = {"name": "gpt_video_ft", "visual_ft": ["i3d_flow", "i3d_rgb"],
           "audio_ft": ["vggish"]}
    txt = {"name": "gpt_dialogue", "max_turns": 3}
    for B in (JB, TB):
        ds = B.load_builder("avsd_dialogue", _avsd_cfg(root, ann, vis, txt)
                            ).build_datasets()["test"]
        with pytest.raises(TypeError, match="vname"):
            ds[0]
        ds.vis_processor = B.load_processor("blip_image_eval",
                                            {"image_size": 12})
        with pytest.raises(AttributeError, match="get"):
            ds[0]


def test_cli_evaluate_on_the_avsd_yaml_fails_in_both(avsd_files, tmp_path):
    from vlm_compression_tpu.cli import evaluate as JE

    root, ann = avsd_files
    for cli, extra, who in ((JE, [], "jax"), (TE, ["--device", "cpu"],
                                              "port")):
        argv = ["--cfg-path", str(AVSD_YAML), "--job_id", who, *extra,
                "--options", "model.tiny=True",
                f"datasets.avsd_dialogue.build_info.annotations.test=[{ann}]",
                f"datasets.avsd_dialogue.build_info.images.storage={root}",
                "run.test_splits=[test]", f"run.output_dir={tmp_path / who}"]
        with pytest.raises(TypeError, match="vname"):
            cli.main(argv)


# ------------------------------------------------------------ the task


def _padded(samples):
    n = max(len(s["input_ids"]) for s in samples)
    out = {}
    for key, fill in (("input_ids", 0), ("token_type_ids", 0),
                      ("labels", -1)):
        out[key] = np.stack([np.pad(s[key], (0, n - len(s[key])),
                                    constant_values=fill) for s in samples])
    return out


@pytest.mark.parametrize("mode_video", [True, False])
def test_dialogue_task_metric_matches_jax(models, mode_video):
    """``valid_step`` over two batches of processor-built streams (with
    the video features, or without), then ``after_evaluation``'s mean."""
    jm, variables, tm = models(masks=True)
    rng = np.random.default_rng(5)
    proc = TP.GPTDialogueProcessor(tokenizer=TTok.SimpleTokenizer(58))
    batches = []
    for b in (3, 2):
        samples = [proc(avsd_annotation(rng, i)) for i in range(b)]
        batch = _padded(samples)
        # the special ids past the vocabulary of 58: 58..62 < 64
        if mode_video:
            batch["video_fts"] = rng.standard_normal(
                (b, 3, 8)).astype(np.float32)
        batch["instance_id"] = list(range(b))
        batches.append(batch)
    jt = JD.DialogueTask.setup_task()
    tt = TD.DialogueTask.setup_task({"run": {"max_len": 20}})
    want = [x for bt in batches
            for x in jt.valid_step(FlaxModel(jm, variables), bt)]
    got = [x for bt in batches for x in tt.valid_step(tm, bt)]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    wm = jt.after_evaluation(want)["agg_metrics"]
    gm = tt.after_evaluation(got)["agg_metrics"]
    assert abs(gm - wm) <= 1e-5 and gm > 0
    assert tt.after_evaluation([])["agg_metrics"] == 0.0


def test_dialogue_task_default_prepare_matches_jax():
    """Without ``input_ids`` the task tokenizes ``text_input`` and
    ``text_output`` (labels −100 on the pads), as the JAX task does."""
    samples = {"text_input": ["a b c", "d e"], "text_output": ["x", "y z"],
               "image": np.zeros((2, 2), np.float32)}
    jt = JD.DialogueTask(tokenizer=JTok.SimpleTokenizer(64), max_len=8)
    tt = TD.DialogueTask(tokenizer=TTok.SimpleTokenizer(64), max_len=8)
    want, got = jt.prepare_batch(samples), tt.prepare_batch(samples)
    assert set(got) == set(want)
    for k in ("input_ids", "attention_mask", "labels"):
        np.testing.assert_array_equal(got[k], want[k])
