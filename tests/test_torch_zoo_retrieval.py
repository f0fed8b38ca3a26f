"""The legacy zoo's retrieval in the port vs the JAX package on the CPU:
``zoo_sim_matrix`` for BLIP-1, ALBEF, CLIP and EVA-CLIP at ``k_test`` 0 and
above, the retrieval task's zoo branch, and ``cli.evaluate`` on a zoo
project yaml through both packages' CLIs, at tiny float32 widths
(parameters from JAX's init, perturbed and masked from a numpy seed, as in
``tests/test_torch_zoo_models.py``).

Tolerances: scores within atol = rtol = 1e-4; the −100.0 fill (which
entries kept it), the reranked entries, the candidate order of the rerank
and every R@k exact.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import numpy_tree
from test_torch_zoo_models import init_zoo
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.datasets import tokenization as JTok
from vlm_compression_tpu.tasks import retrieval as JR
from vlm_compression_tpu_torch.cli import evaluate as TE
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.tasks import retrieval as TR

TOL = dict(atol=1e-4, rtol=1e-4)
ROOT = Path(__file__).resolve().parents[1]
WORDS = ("a dog cat man woman red blue sits runs on the grass street "
         "near two small big").split()
FAMILIES = ("blip_retrieval", "albef_retrieval", "clip", "eva_clip")


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def retrieval_set(seed, n_img=6, per_image=2, batches=(4, 2)):
    """Images in ragged batches and ``per_image`` captions of 2-7 words an
    image."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n_img, 28, 28, 3)).astype(np.float32)
    text = [" ".join(rng.choice(WORDS, rng.integers(2, 8)))
            for _ in range(n_img * per_image)]
    cuts = np.cumsum((0,) + batches)
    return dict(images=[images[a:b] for a, b in zip(cuts[:-1], cuts[1:])],
                text=text, txt2img=[t // per_image for t in range(len(text))],
                img2txt={i: list(range(i * per_image, (i + 1) * per_image))
                         for i in range(n_img)})


@pytest.fixture(scope="module")
def models():
    return {arch: init_zoo(arch, seed=30 + i)
            for i, arch in enumerate(FAMILIES)}


def _sims(models, arch, k_test, enc_token_id=None):
    jm, variables, tm = models[arch]
    data = retrieval_set(3)
    ids, mask = TTok.batch_encode(TTok.SimpleTokenizer(64), data["text"], 35)
    want = JR.zoo_sim_matrix(jm, variables,
                             [jnp.asarray(b) for b in data["images"]],
                             jnp.asarray(ids), jnp.asarray(mask),
                             k_test=k_test, enc_token_id=enc_token_id)
    got = TR.zoo_sim_matrix(tm, [torch.from_numpy(b) for b in data["images"]],
                            ids, mask, k_test=k_test,
                            enc_token_id=enc_token_id)
    return [np.asarray(w) for w in want], got


@pytest.mark.parametrize("k_test", [0, 3, 20])
@pytest.mark.parametrize("arch", FAMILIES)
def test_zoo_sim_matrix_matches_jax(models, arch, k_test):
    """k_test 3 reranks 3 of 12 captions an image and 3 of 6 images a
    caption; 20 exceeds both, so every entry is reranked.  The −100.0
    fill stays where JAX's stays; CLIP ignores k_test (pure ITC)."""
    want, got = _sims(models, arch, k_test)
    itc = _sims(models, arch, 0)[1]
    for g, w, s in zip(got, want, itc):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g == -100.0, w == -100.0)
        np.testing.assert_allclose(g, w, **TOL)
        if not k_test or arch.endswith("clip"):
            np.testing.assert_array_equal(g, s)
            continue
        k = min(k_test, g.shape[1])
        assert ((g != -100.0).sum(1) == k).all()
        picked = np.argsort(s, axis=1)[:, ::-1][:, :k]
        for row, cols in enumerate(picked):
            assert set(np.flatnonzero(g[row] != -100.0)) == set(cols)


@pytest.mark.parametrize("arch", ["blip_retrieval", "albef_retrieval"])
def test_blip_swaps_in_the_enc_token_for_the_itm_pass_only(models, arch):
    """BLIP-1 fuses from ids with ``enc_token_id`` at position 0 (its ITC
    keeps the [CLS] ids); ALBEF fuses from hidden states and ignores it."""
    want, got = _sims(models, arch, 3, enc_token_id=5)
    plain = _sims(models, arch, 3)[1]
    for g, w, p in zip(got, want, plain):
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_array_equal(g == -100.0, p == -100.0)
        if arch.startswith("blip"):
            assert not np.allclose(g[g != -100.0], p[p != -100.0])
        else:
            np.testing.assert_array_equal(g, p)


def test_rerank_candidates_keep_numpys_order_ties_included():
    """Ties in a row come in ``np.argsort(row)[::-1]`` order: the highest
    index first among equals."""
    base = np.array([[0.5, 0.9, 0.5, 0.9, 0.1],
                     [0.2, 0.2, 0.2, 0.2, 0.2]], np.float32)
    want = [np.argsort(row)[::-1][:3] for row in base]
    np.testing.assert_array_equal(TR._topk_rows(base, 3), np.stack(want))


class _Loader:
    def __init__(self, data):
        self.dataset = type("RetrievalSet", (), dict(
            text=data["text"], txt2img=data["txt2img"],
            img2txt=data["img2txt"]))()
        self._images = data["images"]

    def __iter__(self):
        return iter({"image": b} for b in self._images)


@pytest.mark.parametrize("arch", FAMILIES)
def test_retrieval_task_zoo_branch_matches_jax(models, arch, tmp_path):
    """``evaluation`` + ``after_evaluation`` at k_test 3: the scores within
    the tolerance, every R@k and the ``evaluate.txt`` line equal."""
    jm, variables, tm = models[arch]
    data = retrieval_set(4)
    jtask = JR.RetrievalTask(k_test=3, tokenizer=JTok.SimpleTokenizer(64))
    ttask = TR.RetrievalTask(k_test=3, tokenizer=TTok.SimpleTokenizer(64))
    want = jtask.evaluation(FlaxModel(jm, variables), _Loader(data))
    got = ttask.evaluation(tm, _Loader(data))
    for key in ("score_i2t", "score_t2i"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]), **TOL)
    lines = []
    for task, res, label in ((jtask, want, "jax"), (ttask, got, "port")):
        metrics = task.after_evaluation(
            res, split_name="test", result_dir=str(tmp_path / label / "res"))
        lines.append((metrics, (tmp_path / label / "evaluate.txt")
                      .read_text()))
    assert lines[0] == lines[1]


def test_task_refuses_the_instructblip_compositions():
    from vlm_compression_tpu_torch.models.factory import build_model

    tm = build_model(dict(arch="blip2_t5_instruct", tiny=True), device="cpu")
    with pytest.raises(NotImplementedError, match="no retrieval head"):
        TR.RetrievalTask(k_test=2).evaluation(tm, _Loader(retrieval_set(5)))


# ------------------------------------------------------------ through the CLIs


BLIP_RET_YAML = ROOT / "configs/projects/blip/eval/ret_flickr_eval.yaml"
ALBEF_RET_YAML = ROOT / "configs/projects/albef/eval/ret_flickr30k_eval.yaml"


def _write_set(root: Path, n_img=6, per_image=2, seed=6) -> str:
    """PNG images (both packages read them) and a Flickr30k-style
    annotation list."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "img").mkdir(parents=True)
    anns = []
    for i in range(n_img):
        px = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        Image.fromarray(px).save(root / "img" / f"{i}.png")
        anns.append({"image": f"{i}.png", "caption": [
            " ".join(rng.choice(WORDS, rng.integers(2, 8)))
            for _ in range(per_image)]})
    ann = root / "test.json"
    ann.write_text(json.dumps(anns))
    return str(ann)


def _options(root: Path, dataset: str, ann: str, who: str):
    return ["--options", "model.tiny=True", "model.amp=False",
            f"datasets.{dataset}.build_info.annotations.test=[{ann}]",
            f"datasets.{dataset}.build_info.images.storage={root / 'img'}",
            f"datasets.{dataset}.vis_processor.eval.image_size=28",
            "run.batch_size_eval=4", "run.k_test=3",
            f"run.output_dir={root / who}"]


@pytest.mark.parametrize("yaml_path,dataset", [(BLIP_RET_YAML, "flickr30k"),
                                               (ALBEF_RET_YAML, "flickr30k")])
def test_cli_evaluate_zoo_retrieval_matches_jax(tmp_path, yaml_path,
                                                dataset):
    """``cli.evaluate`` on a zoo project yaml: the JAX CLI from its
    ``--seed``, the port's from the same initial weights (carried by a
    state dict); R@k equal."""
    from vlm_compression_tpu.cli import evaluate as JE
    from vlm_compression_tpu.common.config import Config
    from vlm_compression_tpu.models.factory import build_model
    from vlm_compression_tpu.models.model_zoo import default_config_path
    from vlm_compression_tpu_torch.models.bridge import load_jax_variables
    from vlm_compression_tpu_torch.models.factory import (
        build_model as port_build,
    )

    ann = _write_set(tmp_path)
    opts = _options(tmp_path, dataset, ann, "jax")
    jstats = JE.main(["--cfg-path", str(yaml_path), "--job_id", "jx", *opts])
    model_cfg = Config(cfg_path=str(yaml_path), defaults=default_config_path,
                       options=opts[1:]).model_cfg
    _, variables = build_model(model_cfg, seed=42)
    init = port_build(dict(model_cfg), device="cpu")
    load_jax_variables(init, numpy_tree(
        {k: v for k, v in variables.items() if k in ("params", "masks")}))
    init_path = tmp_path / "init.pt"
    torch.save(init.state_dict(), init_path)
    tstats = TE.main(["--cfg-path", str(yaml_path), "--job_id", "tx",
                      "--device", "cpu", "--pruned_checkpoint",
                      str(init_path),
                      *_options(tmp_path, dataset, ann, "port")])
    want, got = jstats["eval_results"]["test"], tstats["eval_results"]["test"]
    assert set(got) == set(want) and "txt_r1" in got
    assert got == want
