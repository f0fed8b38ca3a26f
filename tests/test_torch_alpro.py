"""ALPRO over video in the port vs the JAX package on the CPU: the
TimeSformer tower, ``AlproRetrieval`` (its losses, VTC features and VTM
logits), ``AlproQA``, ``zoo_sim_matrix`` over video batches at ``k_test``
0 and above, ``cli.evaluate`` on the MSRVTT retrieval yaml through both
packages' CLIs, the ALPRO video processors and the seven video builders
with their items, at tiny float32 widths.  Parameters come from JAX's own
init (biases and norm parameters perturbed from a numpy seed, a random
keep-mask on every linear in masked mode), crossed by the weight bridge
with strict keys; inputs come from the same numpy seed.

Tolerances: model outputs within fp32 atol = rtol = 1e-5; similarity
scores within 1e-4 with the −100.0 fill exact; R@k, predictions,
processors and items exact.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import F32, numpy_tree, random_masks
from test_torch_zoo_models import (
    close,
    japply,
    perturb,
    tapply,
    text,
    to_port_config,
)
from vlm_compression_tpu.datasets import builders as JB
from vlm_compression_tpu.datasets import processors as JP
from vlm_compression_tpu.models import alpro as JA
from vlm_compression_tpu.models import factory as JF
from vlm_compression_tpu.models import med as JM
from vlm_compression_tpu.tasks import retrieval as JR
from vlm_compression_tpu_torch.cli import evaluate as TE
from vlm_compression_tpu_torch.datasets import builders as TB
from vlm_compression_tpu_torch.datasets import processors as TP
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.models import factory as TF
from vlm_compression_tpu_torch.models.bridge import (
    flatten,
    load_jax_variables,
)
from vlm_compression_tpu_torch.tasks import retrieval as TR

MODES = ("masked", "dense")
ROOT = Path(__file__).resolve().parents[1]
ALPRO_RET_YAML = ROOT / "configs/projects/alpro/eval/msrvtt_ret_eval.yaml"
WORDS = "a dog cat man red blue runs on the grass street near two".split()


def alpro_config(**kw):
    return JA.AlproConfig.tiny(
        timesformer=JA.TimeSformerConfig.tiny(**F32),
        med=JM.MedConfig.tiny(fusion_start=1, **F32), **kw)


def init_alpro(arch, seed, masks=True):
    """(jax module, numpy variables, port module loaded from them)."""
    from vlm_compression_tpu.common.registry import registry
    from vlm_compression_tpu.models import _ensure_zoo_imported

    _ensure_zoo_imported()
    rng = np.random.default_rng(seed)
    jcfg = alpro_config()
    jm = registry.get_model_class(arch)(jcfg)
    batch = JF._legacy_example_batch(arch, jcfg, batch=2)
    variables = numpy_tree(dict(jm.init(jax.random.key(seed), **batch)))
    variables["params"] = perturb(variables["params"], rng)
    variables.pop("calib", None)
    if masks:
        variables["masks"] = random_masks(variables["params"], rng)
    else:
        variables.pop("masks", None)
    tm = TF._MODELS[arch](to_port_config(jcfg), device="cpu")
    load_jax_variables(tm, variables, strict=True)
    return jm, variables, tm


def videos(rng, b, t=2, size=28):
    return rng.standard_normal((b, t, size, size, 3)).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch, masks=True):
        if (arch, masks) not in cache:
            cache[arch, masks] = init_alpro(arch, 40 + len(cache), masks)
        return cache[arch, masks]

    return get


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("frames", [2, 1])
def test_timesformer_matches_jax(models, mode, frames):
    jm, variables, tm = models("alpro_retrieval", masks=mode == "masked")
    vid = videos(np.random.default_rng(1), 3, frames)

    def enc(m, v):
        return m.encode_video(v, mode=mode)

    close(tapply(tm.encode_video, vid, mode=mode),
          japply(jm, variables, vid, method=enc))


def test_more_frames_than_time_embed_raise_in_both():
    """The QA yamls' n_frms 16 on the factory's 8-frame tower: JAX's
    broadcast fails; the port raises with the reason."""
    jm, variables, tm = init_alpro("alpro_qa", 41, masks=False)
    vid = videos(np.random.default_rng(2), 1, 3)
    ids, mask = text(np.random.default_rng(2), 1, 4)
    with pytest.raises(TypeError, match="broadcast"):
        japply(jm, variables, vid, ids, mask)
    with pytest.raises(ValueError, match="time_embed holds 2"):
        tapply(tm, vid, ids, mask)


@pytest.mark.parametrize("mode", MODES)
def test_alpro_retrieval_losses_features_and_vtm_match_jax(models, mode):
    jm, variables, tm = models("alpro_retrieval", masks=mode == "masked")
    rng = np.random.default_rng(3)
    vid = videos(rng, 3)
    ids, mask = text(rng, 3, 6)
    close(tapply(tm, vid, ids, mask, mode=mode),
          japply(jm, variables, vid, ids, mask, mode=mode))

    def feats(m, v, i, a):
        return m.vtc_feats(v, i, a, mode=mode)

    want = japply(jm, variables, vid, ids, mask, method=feats)
    got = tapply(tm.vtc_feats, vid, ids, mask, mode=mode)
    for g, w in zip(got, want):
        close(g, w)

    def vtm(m, t, a, v):
        return m.itm_logits(t, a, v, mode=mode)

    close(tm.itm_logits(got[3], torch.from_numpy(mask), got[2], mode=mode),
          japply(jm, variables, want[3], mask, want[2], method=vtm))


@pytest.mark.parametrize("mode", MODES)
def test_alpro_qa_matches_jax(models, mode):
    jm, variables, tm = models("alpro_qa", masks=mode == "masked")
    rng = np.random.default_rng(4)
    vid = videos(rng, 3)
    ids, mask = text(rng, 3, 5)
    labels = np.array([1, 0, 1], np.int32)
    for kw in (dict(labels=labels), {}):
        close(tapply(tm, vid, ids, mask, mode=mode, **kw),
              japply(jm, variables, vid, ids, mask, mode=mode, **kw))


@pytest.mark.parametrize("arch", ["alpro_retrieval", "alpro_qa"])
def test_alpro_bridge_builds_the_jax_tree_leaf_for_leaf(models, arch):
    _, variables, tm = models(arch)
    params = {".".join(p): v for p, v in flatten(variables["params"]).items()}
    named = dict(tm.named_parameters())
    assert set(named) == set(params)
    for name, v in params.items():
        np.testing.assert_array_equal(named[name].numpy(), v)
    built = TF.build_model(dict(arch=arch, tiny=True), device="cpu")
    assert float(built.temp) == np.float32(0.07)
    assert tuple(built.visual_encoder.time_embed.shape) == (1, 2, 16)


@pytest.mark.parametrize("node", [dict(model_type="msrvtt"),
                                  dict(model_type="msvd", num_classes=7,
                                       n_frms=16),
                                  dict(tiny=True, num_classes=3)])
@pytest.mark.parametrize("arch", ["alpro_retrieval", "alpro_qa"])
def test_factory_alpro_configs_match_jax(arch, node):
    _, jcfg = JF.build_model_config(dict(node, arch=arch))
    _, tcfg = TF.build_model_config(dict(node, arch=arch))
    assert tcfg == to_port_config(jcfg)
    if not node.get("tiny"):
        assert (tcfg.timesformer.num_frames, tcfg.timesformer.img_size,
                tcfg.med.fusion_start) == (8, 224, 6)


# ------------------------------------------------------------ retrieval


def video_set(seed, n_vid=5, per_video=2):
    rng = np.random.default_rng(seed)
    vids = videos(rng, n_vid)
    caps = [" ".join(rng.choice(WORDS, rng.integers(2, 7)))
            for _ in range(n_vid * per_video)]
    return [vids[:3], vids[3:]], caps


@pytest.mark.parametrize("k_test", [0, 3])
def test_zoo_sim_matrix_on_alpro_matches_jax(models, k_test):
    jm, variables, tm = models("alpro_retrieval")
    batches, caps = video_set(5)
    ids, mask = TTok.batch_encode(TTok.SimpleTokenizer(64), caps, 35)
    want = JR.zoo_sim_matrix(jm, variables, [jnp.asarray(b) for b in batches],
                             jnp.asarray(ids), jnp.asarray(mask),
                             k_test=k_test)
    got = TR.zoo_sim_matrix(tm, [torch.from_numpy(b) for b in batches], ids,
                            mask, k_test=k_test)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g == -100.0, w == -100.0)
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)
    if k_test:
        assert ((got[0] != -100.0).sum(1) == k_test).all()


def _write_videos(root: Path, n_vid=5, per_video=2, seed=6) -> str:
    """uint8 .npy frame stacks (5 frames of 30 × 36) and an MSRVTT-style
    annotation list."""
    rng = np.random.default_rng(seed)
    (root / "vid").mkdir(parents=True)
    anns = []
    for i in range(n_vid):
        np.save(root / "vid" / f"{i}.npy",
                rng.integers(0, 256, (5, 30, 36, 3), dtype=np.uint8))
        anns.append({"video": f"{i}.npy", "caption": [
            " ".join(rng.choice(WORDS, rng.integers(2, 7)))
            for _ in range(per_video)]})
    ann = root / "test.json"
    ann.write_text(json.dumps(anns))
    return str(ann)


def _options(root: Path, ann: str, who: str):
    return ["--options", "model.tiny=True", "model.amp=False",
            f"datasets.msrvtt_retrieval.build_info.annotations.test=[{ann}]",
            f"datasets.msrvtt_retrieval.build_info.images.storage="
            f"{root / 'vid'}",
            "datasets.msrvtt_retrieval.vis_processor.eval.image_size=28",
            "datasets.msrvtt_retrieval.vis_processor.eval.n_frms=2",
            "run.batch_size_eval=3", "run.k_test=3",
            f"run.output_dir={root / who}"]


def test_cli_evaluate_alpro_retrieval_matches_jax(tmp_path):
    """``cli.evaluate`` on msrvtt_ret_eval.yaml: the JAX CLI from its
    ``--seed``, the port's from the same initial weights (a state dict);
    R@k equal."""
    from vlm_compression_tpu.cli import evaluate as JE
    from vlm_compression_tpu.common.config import Config
    from vlm_compression_tpu.models.factory import build_model
    from vlm_compression_tpu.models.model_zoo import default_config_path

    ann = _write_videos(tmp_path)
    opts = _options(tmp_path, ann, "jax")
    jstats = JE.main(["--cfg-path", str(ALPRO_RET_YAML), "--job_id", "jx",
                      *opts])
    model_cfg = Config(cfg_path=str(ALPRO_RET_YAML),
                       defaults=default_config_path,
                       options=opts[1:]).model_cfg
    _, variables = build_model(model_cfg, seed=42)
    init = TF.build_model(dict(model_cfg), device="cpu")
    load_jax_variables(init, numpy_tree(
        {k: v for k, v in variables.items() if k in ("params", "masks")}))
    init_path = tmp_path / "init.pt"
    torch.save(init.state_dict(), init_path)
    tstats = TE.main(["--cfg-path", str(ALPRO_RET_YAML), "--job_id", "tx",
                      "--device", "cpu", "--pruned_checkpoint",
                      str(init_path), *_options(tmp_path, ann, "port")])
    want, got = jstats["eval_results"]["test"], tstats["eval_results"]["test"]
    assert set(got) == set(want) and "txt_r1" in got
    assert got == want


# ------------------------------------------------------------ data


def _stack(rng, t=7, h=30, w=36, dtype=np.uint8):
    if dtype == np.uint8:
        return rng.integers(0, 256, (t, h, w, 3), dtype=np.uint8)
    return rng.random((t, h, w, 3)).astype(np.float32)


@pytest.mark.parametrize("name", ["alpro_video_eval", "alpro_video_train"])
@pytest.mark.parametrize("n_frms,t", [(4, 7), (8, 3)])
def test_alpro_video_processors_equal_jax(name, n_frms, t):
    """uint8 and [0, 1] float stacks, a list of frames; subsampled or
    repeated to n_frms; the train crop and flip from the same generator."""
    from PIL import Image

    rng = np.random.default_rng(n_frms + t)
    cfg = {"image_size": 24, "n_frms": n_frms}
    jp, tp = JP.load_processor(name, cfg), TP.load_processor(name, cfg)
    for stack in (_stack(rng, t), _stack(rng, t, dtype=np.float32),
                  _stack(rng, t, 36, 30)):
        jp.rng, tp.rng = np.random.default_rng(3), np.random.default_rng(3)
        want = jp(stack)
        got = tp(stack)
        assert got.shape == (n_frms, 24, 24, 3) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        if stack.dtype == np.uint8:
            np.testing.assert_array_equal(
                tp(list(stack)), jp([Image.fromarray(f) for f in stack]))
        assert jp.rng.random() == tp.rng.random()


VIDEO_BUILDERS = ("msrvtt_caption", "msvd_caption", "vatex_caption",
                  "msrvtt_retrieval", "didemo_retrieval", "msrvtt_qa",
                  "msvd_qa")


@pytest.fixture(scope="module")
def video_files(tmp_path_factory):
    """Frame stacks as uint8 .npy, [0, 255] and [0, 1] float .npy, and a
    directory of PNG frames; caption / retrieval / QA annotations over
    them."""
    from PIL import Image

    root = tmp_path_factory.mktemp("videos")
    rng = np.random.default_rng(7)
    specs = []
    for i in range(4):
        stack = _stack(rng, 3 + i, 20, 26)
        if i == 1:
            np.save(root / f"{i}.npy", stack.astype(np.float32))
        elif i == 2:
            np.save(root / f"{i}.npy", stack.astype(np.float32) / 255.0)
        else:
            np.save(root / f"{i}.npy", stack)
        specs.append(f"{i}.npy")
    (root / "frames").mkdir()
    for j, f in enumerate(_stack(rng, 5, 22, 24)):
        Image.fromarray(f).save(root / "frames" / f"{j:02d}.png")
    specs.append("frames")
    anns = []
    for i, spec in enumerate(specs):
        anns.append({"video": spec, "caption": [f"a dog {i}", "red cat"],
                     "question": f"what is {i}?", "question_id": 10 + i,
                     "answer": ["dog", "cat", "dog"]})
    path = root / "ann.json"
    path.write_text(json.dumps(anns))
    return root, str(path)


@pytest.mark.parametrize("vis", [{"name": "alpro_video_eval", "n_frms": 3,
                                  "image_size": 16},
                                 {"name": "blip_image_eval",
                                  "image_size": 16}])
@pytest.mark.parametrize("name", VIDEO_BUILDERS)
def test_video_builders_and_items_equal_jax(video_files, name, vis):
    """Each video builder's splits through both packages, sample for
    sample (a whole-video processor, and a per-frame one with the items'
    own subsampling to 4 frames), and the collated batches."""
    root, ann = video_files
    cfg = {"build_info": {"annotations": {"train": [ann], "test": [ann]},
                          "images": {"storage": str(root)}},
           "vis_processor": {"train": dict(vis), "eval": dict(vis)},
           "text_processor": {"eval": {"name": "blip_caption"}}}
    jsets = JB.load_builder(name, cfg).build_datasets()
    tsets = TB.load_builder(name, cfg).build_datasets()
    assert set(tsets) == set(jsets) == {"train", "test"}
    for split, jds in jsets.items():
        tds = tsets[split]
        assert type(tds).__name__ == type(jds).__name__
        assert len(tds) == len(jds) == 5
        for attr in ("text", "txt2img", "img2txt"):
            assert getattr(tds, attr, None) == getattr(jds, attr, None)
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
        for key, w in want.items():
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(w))
