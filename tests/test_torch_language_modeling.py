"""C4 perplexity in the port vs the JAX package on the CPU: the text items
(``TextDataset``), the ``c4`` builder, ``LanguageModelingTask`` on
InstructBLIP-T5 (the seq2seq denoiser) and InstructBLIP-Vicuna (LLaMA,
causal; the JAX task is handed the bound module, the only one on which
its ``hasattr(module, "llm_model")`` finds the LLaMA branch) at tiny fp32
widths, and ``cli.evaluate`` on
``configs/projects/eval/c4_prefix_derivative_compute.yaml``.

Items and builder splits equal; each batch's loss within atol = rtol =
1e-5 and its token count equal; the perplexity, its loss and
``agg_metrics`` within 1e-5 (relative), directly and through the two
CLIs (the port's started from the JAX CLI's initial weights, carried
across by the weight bridge), on seeded texts written to ``tmp_path``.
"""

import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import numpy_tree, tiny_blip
from test_torch_vicuna import tiny_vicuna
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.datasets import builders as JB
from vlm_compression_tpu.datasets import items as JI
from vlm_compression_tpu.datasets import tokenization as JTok
from vlm_compression_tpu.datasets.processors import (
    load_processor as jax_processor,
)
from vlm_compression_tpu.tasks import classification as JC
from vlm_compression_tpu_torch.cli import evaluate as TE
from vlm_compression_tpu_torch.datasets import builders as TB
from vlm_compression_tpu_torch.datasets import items as TI
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.datasets.processors import load_processor
from vlm_compression_tpu_torch.tasks import classification as TC
from vlm_compression_tpu_torch.tasks import setup_task

ROOT = Path(__file__).resolve().parents[1]
C4_YAML = ROOT / "configs/projects/eval/c4_prefix_derivative_compute.yaml"
TOL = dict(atol=1e-5, rtol=1e-5)
WORDS = ["the", "a", "dog", "runs", "over", "green", "hills", "while",
         "children", "play", "near", "old", "river", "Stones", "sing"]


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _texts(n, seed=0, shortest=3, longest=20):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(shortest, longest)))
            + "." for _ in range(n)]


def _annotations(root: Path, n=6, seed=0) -> str:
    anns = [{"text": t} for t in _texts(n, seed)]
    anns[1] = {"text_input": anns[1]["text"]}     # the other key C4 takes
    path = root / f"c4_{seed}.json"
    path.write_text(json.dumps(anns))
    return str(path)


def test_text_dataset_matches_jax(tmp_path):
    ann = _annotations(tmp_path)
    args = dict(vis_root="", ann_paths=[ann])
    jd = JI.TextDataset(None, jax_processor("blip_caption"), **args)
    td = TI.TextDataset(None, load_processor("blip_caption"), **args)
    assert len(td) == len(jd) == 6
    items = [td[i] for i in range(len(td))]
    assert items == [jd[i] for i in range(len(jd))]
    assert set(items[0]) == {"text_input", "instance_id"}
    assert td.collater(items) == jd.collater([jd[i] for i in range(6)])
    with pytest.raises(RuntimeError, match="no images"):
        td._image({})


def test_c4_builder_matches_jax(tmp_path):
    cfg = {"build_info": {"annotations": {"train": [_annotations(tmp_path)],
                                          "test": [_annotations(tmp_path,
                                                                seed=1)]}},
           "text_processor": {"train": {"name": "blip_caption"}}}
    want = JB.load_builder("c4", cfg).build_datasets(max_train_samples=4)
    got = TB.load_builder("c4", cfg).build_datasets(max_train_samples=4)
    assert set(got) == set(want) == {"train", "test"}
    for split in got:
        assert isinstance(got[split], TI.TextDataset)
        assert [got[split][i] for i in range(len(got[split]))] == \
            [want[split][i] for i in range(len(want[split]))]
    assert len(got["train"]) == 4


def _batches(texts, bs):
    return [{"text_input": texts[i:i + bs],
             "instance_id": list(range(i, i + len(texts[i:i + bs])))}
            for i in range(0, len(texts), bs)]


@pytest.fixture(scope="module")
def models():
    jt5, vt5, tt5, _ = tiny_blip(seed=71, masks=True)
    jv, vv, tv, _ = tiny_vicuna(seed=72, masks=True)
    return {"t5": (jt5, vt5, tt5, jt5.cfg.t5.vocab_size),
            "llama": (jv, vv, tv, jv.cfg.llm.vocab_size)}


@pytest.mark.parametrize("family", ["t5", "llama"])
def test_language_modeling_task_matches_jax(models, family):
    """Each batch's token-mean loss and token count, then the token-weighted
    perplexity: ragged texts, BOS and EOS added, labels -100 off the mask,
    one text cut at ``max_len``."""
    jm, variables, tm, vocab = models[family]
    texts = _texts(7, seed=3)
    texts[2] = " ".join(WORDS * 3)                # longer than max_len 24
    jt = JC.LanguageModelingTask(tokenizer=JTok.SimpleTokenizer(vocab),
                                 max_len=24)
    tt = TC.LanguageModelingTask(tokenizer=TTok.SimpleTokenizer(vocab),
                                 max_len=24)
    variables = jax.tree_util.tree_map(jnp.asarray, variables)
    # the JAX task picks its branch by ``hasattr(module, "llm_model")``,
    # which a Flax module built in ``setup`` answers only once bound
    flax = FlaxModel(jm.bind(variables), variables)
    want = jt.evaluation(flax, _batches(texts, 3))
    got = tt.evaluation(tm, _batches(texts, 3))
    assert [r["n_tokens"] for r in got] == [r["n_tokens"] for r in want]
    assert got[0]["n_tokens"] == sum(len(t.split()) + 2 for t in texts[:2]) \
        + 24
    np.testing.assert_allclose([r["loss"] for r in got],
                               [r["loss"] for r in want], **TOL)
    wm = jt.after_evaluation(want, split_name="test")
    gm = tt.after_evaluation(got, split_name="test")
    assert set(gm) == set(wm) == {"agg_metrics", "ppl", "loss"}
    for key in gm:
        np.testing.assert_allclose(gm[key], wm[key], **TOL)
    assert gm["agg_metrics"] == -gm["ppl"]
    tot = sum(r["n_tokens"] for r in got)
    avg = sum(r["loss"] * r["n_tokens"] for r in got) / tot
    assert gm["ppl"] == math.exp(min(avg, 20)) and gm["loss"] == avg


def test_perplexity_saturates_as_in_jax():
    res = [{"loss": 30.0, "n_tokens": 4}, {"loss": 10.0, "n_tokens": 0}]
    got = TC.LanguageModelingTask().after_evaluation(res)
    assert got == JC.LanguageModelingTask().after_evaluation(res)
    assert got["ppl"] == math.exp(20)
    assert TC.LanguageModelingTask().after_evaluation([])["ppl"] == 1.0


def test_setup_task_builds_language_modeling():
    task = setup_task({"run": {"task": "language_modeling"}},
                      tokenizer=TTok.SimpleTokenizer(96))
    assert isinstance(task, TC.LanguageModelingTask)
    assert task.max_len == JC.LanguageModelingTask().max_len == 128
    assert task.tokenizer.vocab_size == 96


def _cli_options(root: Path, ann: str, who: str):
    return ["--options", "model.arch=blip2_t5_instruct", "model.tiny=True",
            "model.amp=False",
            f"datasets.c4.build_info.annotations.test=[{ann}]",
            "run.batch_size_eval=3", f"run.output_dir={root / who}"]


def test_cli_evaluate_c4_matches_jax(tmp_path):
    """``cli.evaluate`` on the C4 yaml (its ``blip2_t5`` swapped for the
    InstructBLIP-T5 arch, which both packages build): the JAX CLI from its
    ``--seed``, the port's from the same initial weights."""
    from vlm_compression_tpu.cli import evaluate as JE
    from vlm_compression_tpu.common.config import Config
    from vlm_compression_tpu.models.factory import build_model
    from vlm_compression_tpu.models.model_zoo import default_config_path
    from vlm_compression_tpu_torch.models.bridge import load_jax_variables
    from vlm_compression_tpu_torch.models.factory import (
        build_model as port_build,
    )

    ann = _annotations(tmp_path, n=7, seed=5)
    jstats = JE.main(["--cfg-path", str(C4_YAML), "--job_id", "jx",
                      *_cli_options(tmp_path, ann, "jax")])
    model_cfg = Config(cfg_path=str(C4_YAML), defaults=default_config_path,
                       options=_cli_options(tmp_path, ann, "jax")[1:]
                       ).model_cfg
    _, variables = build_model(model_cfg, seed=42)
    init = port_build(dict(model_cfg), device="cpu")
    load_jax_variables(init, numpy_tree(
        {k: v for k, v in variables.items() if k in ("params", "masks")}))
    init_path = tmp_path / "init.pt"
    torch.save(init.state_dict(), init_path)
    tstats = TE.main(["--cfg-path", str(C4_YAML), "--job_id", "tx",
                      "--device", "cpu", "--pruned_checkpoint",
                      str(init_path), *_cli_options(tmp_path, ann, "port")])
    want, got = jstats["eval_results"]["test"], tstats["eval_results"]["test"]
    assert set(got) == set(want) == {"agg_metrics", "ppl", "loss"}
    for key in got:
        np.testing.assert_allclose(got[key], want[key], **TOL)
    assert 1.0 < got["ppl"] < math.exp(20)
    saved = json.loads((tmp_path / "port" / "eval_stats_tx.json").read_text())
    assert saved["eval_results"]["test"] == got
