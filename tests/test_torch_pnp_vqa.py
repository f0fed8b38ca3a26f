"""PNP-VQA / Img2Prompt in the port vs the JAX package on the CPU: the
Fusion-in-Decoder reader, the ITM patch relevance (a gradient of the ITM
margin with respect to the image tokens), the caption logits over the top
patches (ties to the lower index), ``pnp_predict_answers``, the reading
comprehension tasks and ``cli.evaluate`` on the PNP-VQA VQAv2 yaml, and
``compute_gradcam_map``, at tiny float32 widths (parameters from JAX's
init, perturbed and masked from a numpy seed, crossed by the bridge).

The sampled caption drafts draw from threefry in JAX and from a
``torch.Generator`` in the port: they are held with the same Gumbel draws
injected on both sides; draft 0 (greedy) is held as it comes.

Tolerances: reader logits and loss, relevance and caption logits within
fp32 atol = rtol = 1e-5; answers, captions, gradcam arrays (1e-5),
metrics and result files equal.
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
    to_port_config,
)
from vlm_compression_tpu.common import gradcam as JGC
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.datasets import tokenization as JTok
from vlm_compression_tpu.models import blip1 as JB
from vlm_compression_tpu.models import med as JM
from vlm_compression_tpu.models import pnp_vqa as JP
from vlm_compression_tpu.models import t5 as JT
from vlm_compression_tpu.models import vit as JV
from vlm_compression_tpu.tasks import dialogue_rc as JD
from vlm_compression_tpu_torch.cli import evaluate as TE
from vlm_compression_tpu_torch.common import gradcam as TGC
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.models import factory as TF
from vlm_compression_tpu_torch.models import pnp_vqa as TP
from vlm_compression_tpu_torch.models.bridge import (
    flatten,
    load_jax_variables,
)
from vlm_compression_tpu_torch.tasks import dialogue_rc as TD

MODES = ("masked", "dense")
ROOT = Path(__file__).resolve().parents[1]
PNP_YAML = ROOT / "configs/projects/pnp-vqa/eval/vqav2_eval.yaml"


def pnp_config():
    return JP.PNPVQAConfig.tiny(
        blip=JB.Blip1Config.tiny(vit=JV.ViTConfig.tiny(**F32),
                                 med=JM.MedConfig.tiny(**F32)),
        t5=JT.T5Config.tiny(**F32))


def init_pnp(arch, seed, masks=True):
    from vlm_compression_tpu.models import factory as JF

    rng = np.random.default_rng(seed)
    jcfg = pnp_config()
    if arch == "pnp_unifiedqav2_fid":
        jcfg = jcfg.t5
    jm = {"pnp_vqa": JP.PNPVQA, "img2prompt_vqa": JP.Img2PromptVQA,
          "pnp_unifiedqav2_fid": JP.UnifiedQAv2FiD}[arch](jcfg)
    batch = JF._legacy_example_batch(arch, jcfg, batch=2)
    variables = dict(jm.init(jax.random.key(seed), **batch))
    # the calibration statistics sown inside the relevance's gradient hold
    # tracers: left out
    variables.pop("calib", None)
    variables = numpy_tree(variables)
    variables["params"] = perturb(variables["params"], rng)
    if masks:
        variables["masks"] = random_masks(variables["params"], rng)
    else:
        variables.pop("masks", None)
    tm = TF._MODELS[arch](to_port_config(jcfg), device="cpu")
    load_jax_variables(tm, variables, strict=True)
    # JAX takes the gradient inside its forward: its masks as JAX arrays
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(arch="pnp_vqa", masks=True):
        if (arch, masks) not in cache:
            cache[arch, masks] = init_pnp(arch, 60 + len(cache), masks)
        return cache[arch, masks]

    return get


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def contexts(rng, b=2, n_ctx=3, length=5):
    ids = rng.integers(2, 96, (b, n_ctx, length)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 1, 2:] = 0
    mask[1, 2, :] = 0          # a whole context padded
    labels = rng.integers(1, 96, (b, 4)).astype(np.int32)
    labels[0, -1] = -100
    return ids, mask, labels


@pytest.mark.parametrize("mode", MODES)
def test_fid_reader_matches_jax(models, mode):
    jm, variables, tm = models("pnp_unifiedqav2_fid", masks=mode == "masked")
    ids, mask, labels = contexts(np.random.default_rng(1))
    close(tapply(tm, ids, mask, labels, mode=mode),
          japply(jm, variables, ids, mask, labels, mode=mode))

    def enc(m, i, a):
        return m.encode_contexts(i, a, mode=mode)

    got = tapply(tm.encode_contexts, ids, mask, mode=mode)
    want = japply(jm, variables, ids, mask, method=enc)
    assert tuple(got[0].shape) == (2, 15, 16)
    for g, w in zip(got, want):
        close(g, w)


def images(rng, b):
    return rng.standard_normal((b, 28, 28, 3)).astype(np.float32)


def question(rng, b=2, n=5):
    ids = rng.integers(4, 64, (b, n)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, -2:] = 0
    return ids, mask


@pytest.mark.parametrize("mode", MODES)
def test_relevance_and_caption_logits_match_jax(models, mode):
    """The relevance is a gradient taken inside the forward: it must come
    out under the caller's ``no_grad`` too (the autouse fixture)."""
    jm, variables, tm = models(masks=mode == "masked")
    rng = np.random.default_rng(2)
    img = images(rng, 2)
    q_ids, q_mask = question(rng)

    def itm(m, *a):
        return m.forward_itm(*a, mode=mode)

    want_rel, want_img = japply(jm, variables, img, q_ids, q_mask,
                                method=itm)
    got_rel, got_img = tapply(tm.forward_itm, img, q_ids, q_mask, mode=mode)
    assert tuple(got_rel.shape) == (2, 4) and float(got_rel.abs().sum()) > 0
    close(got_rel, want_rel)
    close(got_img, want_img)
    cap_ids, cap_mask = question(rng, 2, 4)
    ctx_ids, ctx_mask, labels = contexts(rng)
    kw = dict(cap_ids=cap_ids, ctx_ids=ctx_ids, ctx_mask=ctx_mask,
              labels=labels)
    close(tapply(tm, img, q_ids, q_mask, **kw, mode=mode),
          japply(jm, variables, img, q_ids, q_mask, **kw, mode=mode))


def test_caption_patches_break_ties_to_the_lower_index(models):
    """Relevance with ties (and an all-zero row): the patches the caption
    reads are ``jax.lax.top_k``'s."""
    jm, variables, tm = models()
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((3, 5, 16)).astype(np.float32)
    rel = np.array([[0.5, 0.5, 0.1, 0.5], [0, 0, 0, 0],
                    [0.2, 0.7, 0.7, 0.1]], np.float32)
    cap_ids, _ = question(rng, 3, 3)
    for k in (1, 2, 3):
        np.testing.assert_array_equal(
            TP.top_k_lower_index(torch.from_numpy(rel), k).numpy(),
            np.asarray(jax.lax.top_k(jnp.asarray(rel), k)[1]))

    def cap(m, e, r, c):
        return m.forward_cap(e, r, c)

    close(tapply(tm.forward_cap, emb, rel, cap_ids),
          japply(jm, variables, emb, rel, cap_ids, method=cap))


@pytest.mark.parametrize("arch", ["pnp_vqa", "pnp_unifiedqav2_fid"])
def test_pnp_bridge_builds_the_jax_tree_leaf_for_leaf(models, arch):
    _, variables, tm = models(arch)
    params = {".".join(p): v for p, v in flatten(variables["params"]).items()}
    for name, p in tm.named_parameters():
        np.testing.assert_array_equal(p.numpy(), np.asarray(params[name]))
    assert set(dict(tm.named_parameters())) == set(params)
    built = TF.build_model(dict(arch=arch, tiny=True, amp=False),
                           device="cpu")
    assert set(dict(built.named_parameters())) == set(params)
    if arch == "pnp_vqa":
        assert not hasattr(built.cap, "visual_encoder")
        assert not hasattr(built.itm, "vision_proj")


def test_factory_pnp_configs_match_jax():
    from vlm_compression_tpu.models import factory as JF

    for arch in ("pnp_vqa", "img2prompt_vqa", "pnp_unifiedqav2_fid"):
        for node in (dict(model_type="base"), dict(tiny=True)):
            _, jcfg = JF.build_model_config(dict(node, arch=arch))
            _, tcfg = TF.build_model_config(dict(node, arch=arch))
            assert tcfg == to_port_config(jcfg)
    assert (tcfg.d_model, tcfg.num_layers) == (16, 2)
    _, base = TF.build_model_config(dict(arch="pnp_vqa"))
    assert (base.blip.vit.img_size, base.t5.d_model, base.t5.num_layers,
            base.num_captions) == (224, 2048, 24, 50)


def test_img2prompt_build_prompt_equals_jax():
    for caps, q, ex in ((["a dog", "on grass"], "what?", None),
                        ([], "why", [("q1", "a1"), ("q2", "a2")])):
        assert TP.Img2PromptVQA.build_prompt(caps, q, ex) == \
            JP.Img2PromptVQA.build_prompt(caps, q, ex)


def test_compute_gradcam_map_equals_jax():
    rng = np.random.default_rng(4)
    attn = rng.random((3, 6, 10)).astype(np.float32)
    grad = rng.standard_normal((3, 6, 10)).astype(np.float32)
    np.testing.assert_array_equal(TGC.compute_gradcam_map(attn, grad, 3),
                                  JGC.compute_gradcam_map(attn, grad, 3))
    img = rng.random((20, 24, 3)).astype(np.float32)
    amap = rng.random((4, 4)).astype(np.float32)
    for blur, overlap in ((True, True), (False, False)):
        np.testing.assert_array_equal(
            TGC.getAttMap(img, amap, blur, overlap),
            JGC.getAttMap(img, amap, blur, overlap))


# ------------------------------------------------------------ the pipeline


class _Draws:
    """The same Gumbel draws for both samplers: argmax(logits + G_k) at
    the k-th sampled step."""

    def __init__(self, seed, b, vocab):
        self.g = np.random.default_rng(seed).gumbel(size=(64, b, vocab)) \
            .astype(np.float32)
        self.k = 0

    def jax(self, key, logits):
        out = jnp.argmax(logits + self.g[self.k], -1)
        self.k += 1
        return out

    def port(self, logits):
        out = torch.argmax(logits + torch.from_numpy(self.g[self.k]), -1)
        self.k += 1
        return out


def _qa_inputs(seed):
    rng = np.random.default_rng(seed)
    tok = JTok.SimpleTokenizer(64)
    qs = ["what is the dog", "where is it now", "who sits"]
    ids, mask = TTok.batch_encode(TTok.SimpleTokenizer(64), qs, 32)
    return images(rng, 3), ids, mask, tok, qs


def test_pnp_predict_answers_matches_jax(models, monkeypatch):
    """Draft 0 greedy and two sampled drafts a question."""
    num_captions = 3
    jm, variables, tm = models()
    img, ids, mask, jtok, _ = _qa_inputs(5)
    draws_j, draws_t = _Draws(6, 3, 64), _Draws(6, 3, 64)
    monkeypatch.setattr(jax.random, "categorical", draws_j.jax)
    want = JD.pnp_predict_answers(jm, variables, jnp.asarray(img),
                                  jnp.asarray(ids), jnp.asarray(mask), jtok,
                                  num_captions=num_captions,
                                  cap_max_length=3, max_len=2)
    got = TD.pnp_predict_answers(tm, torch.from_numpy(img),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(mask),
                                 TTok.SimpleTokenizer(64),
                                 num_captions=num_captions, cap_max_length=3,
                                 max_len=2, sampler=draws_t.port)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert draws_t.k == draws_j.k == (num_captions - 1) * 3
    np.testing.assert_allclose(got[2], np.asarray(want[2]), atol=1e-5,
                               rtol=1e-5)


def test_pnp_predict_answers_own_sampler_replays_its_seed(models):
    _, _, tm = models()
    img, ids, mask, _, _ = _qa_inputs(7)
    args = (tm, torch.from_numpy(img), torch.from_numpy(ids),
            torch.from_numpy(mask), TTok.SimpleTokenizer(64))
    kw = dict(num_captions=3, cap_max_length=4, max_len=2)
    a = TD.pnp_predict_answers(*args, seed=1, **kw)
    b = TD.pnp_predict_answers(*args, seed=1, **kw)
    assert a[:2] == b[:2]
    greedy = TD.pnp_predict_answers(*args, seed=2, **dict(kw,
                                                          num_captions=1))
    assert [c[:1] for c in a[1]] == greedy[1]


@pytest.mark.parametrize("task", ["vqa_reading_comprehension",
                                  "gqa_reading_comprehension"])
def test_reading_comprehension_tasks_match_jax(models, monkeypatch, tmp_path,
                                               task):
    """``valid_step`` over a batch and ``after_evaluation``: the gradcam
    (.npz), caption and answer files and the metrics equal; a GQA split
    with no answers writes the same leaderboard."""
    jm, variables, tm = models()
    img, _, _, _, qs = _qa_inputs(8)
    samples = {"image": img, "text_input": qs, "question_id": [7, 8, 9],
               "answers": [["<5>", "x"], ["y"], ["<5>"]],
               "answer": ["<5>", "y", "z"]}
    jcls = {"vqa_reading_comprehension": JD.VQARCTask,
            "gqa_reading_comprehension": JD.GQARCTask}[task]
    tcls = TD.registry.get_task_class(task)
    run = {"num_captions": 2, "cap_max_length": 3, "max_len": 2}
    jt = jcls(tokenizer=JTok.SimpleTokenizer(64), **run)
    tt = tcls.setup_task({"run": dict(run, task=task)},
                         tokenizer=TTok.SimpleTokenizer(64))
    draws_j, draws_t = _Draws(9, 3, 64), _Draws(9, 3, 64)
    monkeypatch.setattr(jax.random, "categorical", draws_j.jax)
    tt.sampler = draws_t.port
    results = {}
    for label, t, model in (("jax", jt, FlaxModel(jm, variables)),
                            ("port", tt, tm)):
        out = t.valid_step(model, samples)
        res = str(tmp_path / label / "result")
        results[label] = (out, t.after_evaluation(out, split_name="val",
                                                  result_dir=res))
    (jout, jmet), (tout, tmet) = results["jax"], results["port"]
    assert tout[0][1:] == jout[0][1:]
    for g, w in zip(tout[0][0], jout[0][0]):
        assert g["question_id"] == w["question_id"]
        np.testing.assert_allclose(g["gradcam"], w["gradcam"], atol=1e-5)
    assert tmet == jmet
    for name in ("val_caption_result.json", "val_vqa_result.json"):
        assert json.loads((tmp_path / "port/result" / name).read_text()) \
            == json.loads((tmp_path / "jax/result" / name).read_text())
    cams = []
    for who in ("port", "jax"):
        with np.load(tmp_path / who / "result" / "val_gradcam_result.npz",
                     allow_pickle=True) as f:
            cams.append(json.loads(str(f["result"])))
    assert [c["question_id"] for c in cams[0]] == [7, 8, 9]
    np.testing.assert_allclose([c["gradcam"] for c in cams[0]],
                               [c["gradcam"] for c in cams[1]], atol=1e-5)
    if task == "gqa_reading_comprehension":
        del samples["answer"], samples["answers"]
        for label, t, model in (("jax", jt, FlaxModel(jm, variables)),
                                ("port", tt, tm)):
            out = t.valid_step(model, samples)
            t.after_evaluation(out, split_name="test",
                               result_dir=str(tmp_path / label / "lb"))
        assert (tmp_path / "port/lb/leaderboard.json").read_text() == \
            (tmp_path / "jax/lb/leaderboard.json").read_text()


def _write_vqa(root: Path, words) -> str:
    """PNG images and a VQAv2-style annotation list whose question words
    all tokenize inside MED's vocabulary (the CLI tokenizes with the
    reader's: see ``test_the_cli_tokenizer_is_the_readers``)."""
    from PIL import Image

    rng = np.random.default_rng(10)
    (root / "img").mkdir(parents=True)
    anns = []
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (30, 34, 3), dtype=np.uint8)
                        ).save(root / "img" / f"{i}.png")
        anns.append({"image": f"{i}.png",
                     "question": " ".join(rng.choice(words, 3 + i)),
                     "question_id": i, "answer": ["<5>", "no", "<5>"]})
    ann = root / "val.json"
    ann.write_text(json.dumps(anns))
    return str(ann)


def test_cli_evaluate_pnp_vqa_matches_jax(tmp_path):
    """``cli.evaluate`` on the PNP-VQA VQAv2 yaml with one (greedy)
    caption a question: the JAX CLI from its ``--seed``, the port's from
    the same weights (a state dict); the metrics and answers equal."""
    from vlm_compression_tpu.cli import evaluate as JE
    from vlm_compression_tpu.common.config import Config
    from vlm_compression_tpu.models.factory import build_model
    from vlm_compression_tpu.models.model_zoo import default_config_path

    reader_tok = TTok.SimpleTokenizer(96)
    words = [w for w in ("what where who is the dog cat man red blue on it "
                         "sits runs near two one small big grass").split()
             if reader_tok.encode(w)[0] < 64]
    assert len(words) >= 4
    ann = _write_vqa(tmp_path, words)

    def opts(who):
        return ["--options", "model.tiny=True", "model.amp=False",
                f"datasets.coco_vqa.build_info.annotations.val=[{ann}]",
                f"datasets.coco_vqa.build_info.images.storage="
                f"{tmp_path / 'img'}",
                "datasets.coco_vqa.vis_processor.eval.image_size=28",
                "run.num_captions=1", "run.cap_max_length=2",
                "run.max_len=2", f"run.output_dir={tmp_path / who}"]

    jstats = JE.main(["--cfg-path", str(PNP_YAML), "--job_id", "jx",
                      *opts("jax")])
    model_cfg = Config(cfg_path=str(PNP_YAML), defaults=default_config_path,
                       options=opts("jax")[1:]).model_cfg
    _, variables = build_model(model_cfg, seed=42)
    init = TF.build_model(dict(model_cfg), device="cpu")
    load_jax_variables(init, numpy_tree(
        {k: v for k, v in variables.items() if k in ("params", "masks")}))
    torch.save(init.state_dict(), tmp_path / "init.pt")
    tstats = TE.main(["--cfg-path", str(PNP_YAML), "--job_id", "tx",
                      "--device", "cpu", "--pruned_checkpoint",
                      str(tmp_path / "init.pt"), *opts("port")])
    assert tstats["eval_results"] == jstats["eval_results"]
    answers = [json.loads((tmp_path / who / "result" /
                           "val_vqa_result.json").read_text())
               for who in ("port", "jax")]
    assert answers[0] == answers[1] and len(answers[0]) == 2


def test_the_cli_tokenizer_is_the_readers():
    """The CLI hands PNP-VQA one tokenizer of the reader's vocabulary (T5's
    first, as the JAX CLI picks it); MED's is smaller, so a question word
    may hash past it: the port raises there (torch's gather checks its
    indices) where JAX's gather reads out of bounds."""
    model = TF.build_model(dict(arch="pnp_vqa", tiny=True), device="cpu")
    tok, _ = TE._tokenizers(model, {})
    assert tok.vocab_size == model.cfg.t5.vocab_size == 96
    assert model.cfg.blip.med.vocab_size == 64
    ids = torch.tensor([[tok.vocab_size - 1]])
    with pytest.raises(IndexError):
        model.itm.text_encoder.embed(ids)
