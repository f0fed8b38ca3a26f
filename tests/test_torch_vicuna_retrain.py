"""RESSA retraining of InstructBLIP-Vicuna in the port vs the JAX package on
the CPU: one and two KD steps (loss, CE, KL, every LoRA gradient and the
AdamW-updated LoRA) of the tiny fp32 InstructBLIP-Vicuna with the LVQ
ranks (ViT 4, LLaMA 8, Q-Former 2) and seeded non-zero lora_b, with
``accum_grad_iters`` 1 and 2; the merge over the ``llm_model`` subtree;
the adapter state; and the T5 and Vicuna batch preparers.

Tolerances, as ``tests/test_torch_retrain.py`` states them:
- loss, CE, KL: atol = rtol = 1e-4;
- gradients: max |port − JAX| ≤ 1e-4 · max |JAX| per leaf (the second
  step's against JAX's gradient at the port's LoRA after one step);
- the updated LoRA: within 1e-3·lr where a gradient entry is above
  1e-4 × its leaf's scale (after two steps: where both steps' entries
  are), else within the bound of the steps taken (2.1·lr a step);
- the merge: atol = rtol = 1e-6; ids, masks and labels of the preparers
  equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import (
    F32,
    numpy_tree,
    port_config,
    random_masks,
    seeded_lora,
)
from test_torch_vicuna import vicuna_batch
from vlm_compression_tpu.common import optims as JO
from vlm_compression_tpu.datasets import tokenization as JTok
from vlm_compression_tpu.models import blip2_vicuna_instruct as JBV
from vlm_compression_tpu.models import eva_vit as JV
from vlm_compression_tpu.models import llama as JL
from vlm_compression_tpu.models import qformer as JQ
from vlm_compression_tpu.tasks import preparers as JPrep
from vlm_compression_tpu.tasks import retrain as JR
from vlm_compression_tpu_torch.compression import peft_io as TP
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.models import blip2_vicuna_instruct as TBV
from vlm_compression_tpu_torch.models import eva_vit as TV
from vlm_compression_tpu_torch.models import llama as TL
from vlm_compression_tpu_torch.models import qformer as TQ
from vlm_compression_tpu_torch.models.bridge import flatten, load_jax_variables
from vlm_compression_tpu_torch.tasks import preparers as TPrep
from vlm_compression_tpu_torch.tasks import retrain as TR

# scripts/launch_lib.py:87-125 (train_ressa): tune_opt LVQ, KD 0.1 at T 1
RANKS = dict(vit=4, llm=8, qformer=2)
KL_W, T_KD, LR = 0.1, 1.0, 1e-3
BATCH = 4
# lora_b drawn at this std, non-zero so that every factor gets a gradient
# and the merge matters.  At test_torch_models' 0.3 the Q-Former leaves are
# ill-conditioned: the JAX step's own jitted and eager gradients there
# differ by 6e-5 of a leaf's scale, the port's fp32 and fp64 ones by 5e-6
LORA_B_STD = 0.1


def _t(x):
    return torch.from_numpy(np.array(x))


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _lora_leaves(tree):
    return {".".join(p): np.asarray(v) for p, v in flatten(tree).items()}


def tiny_lora_vicuna_configs():
    jcfg = JBV.Blip2VicunaInstructConfig.tiny(
        vit=JV.EvaViTConfig.tiny(lora_rank=RANKS["vit"], **F32),
        qformer=JQ.QFormerConfig.tiny(lora_rank=RANKS["qformer"],
                                      dtype="float32"),
        llm=JL.LlamaConfig.tiny(lora_rank=RANKS["llm"], **F32))
    tcfg = TBV.Blip2VicunaInstructConfig(
        vit=port_config(jcfg.vit, TV.EvaViTConfig),
        qformer=port_config(jcfg.qformer, TQ.QFormerConfig),
        llm=port_config(jcfg.llm, TL.LlamaConfig))
    return jcfg, tcfg


def tiny_lora_vicuna(seed, b=BATCH):
    """(jax module, jax variables (params, lora, masks) as numpy, port
    module, batch): the adapters' lora_b drawn from the seed, random masks
    on every linear."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = tiny_lora_vicuna_configs()
    batch = vicuna_batch(rng, jcfg, b=b)
    jm = JBV.Blip2VicunaInstruct(jcfg)
    variables = numpy_tree(jm.init(
        jax.random.key(seed), **_jnp(batch), vit_mode="sparse_lora",
        llm_mode="sparse_lora", qformer_mode="sparse_lora"))
    variables = dict(params=variables["params"],
                     lora=seeded_lora(variables["lora"], rng, LORA_B_STD),
                     masks=random_masks(variables["params"], rng))
    tm = TBV.Blip2VicunaInstruct(tcfg, device="cpu")
    load_jax_variables(tm, variables)
    return jm, variables, tm, batch


def _grad_fn(jm):
    """JAX's loss of make_kd_train_step, differentiated in the lora
    collection (the step itself returns no gradients)."""
    def grads(variables, lora, batch):
        t_logits = jm.apply({"params": variables["params"]}, **batch,
                            vit_mode="dense", llm_mode="dense",
                            qformer_mode="dense")["logits"]

        def loss_fn(lora):
            out = jm.apply({"params": variables["params"],
                            "masks": variables["masks"], "lora": lora},
                           **batch, vit_mode="sparse_lora",
                           llm_mode="sparse_lora", qformer_mode="sparse_lora")
            return JR.kd_loss(out["loss"], out["logits"], t_logits, KL_W,
                              T_KD)[0]

        return jax.grad(loss_fn)(lora)

    return jax.jit(grads)


def _jax_grads(grad_fn, variables, lora, batch, accum):
    """The step's gradient: the mean over ``accum`` equal micro-batches."""
    b = BATCH // accum
    parts = [_lora_leaves(grad_fn(variables, lora, {
        k: v[i * b:(i + 1) * b] for k, v in batch.items()}))
        for i in range(accum)]
    return {n: sum(p[n] for p in parts) / accum for n in parts[0]}


def _as_tree(like, named):
    """The port's LoRA ``named`` (dotted names) as a JAX tree shaped like
    ``like``."""
    def walk(node, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else jnp.asarray(named[".".join(path + (k,))].detach().numpy())
                for k, v in node.items()}

    return walk(like, ())


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def two_kd_steps(request):
    """Two KD steps of each package from the same variables and batch."""
    accum = request.param
    jm, variables, tm, batch = tiny_lora_vicuna(seed=31)
    jv, jb = _jnp(variables), _jnp(batch)
    tx = JO.make_adamw(weight_decay=0.05)
    jstep = jax.jit(JR.make_kd_train_step(jm, tx, KL_W, T_KD,
                                          accum_grad_iters=accum))
    grad_fn = _grad_fn(jm)
    jstate = JR.RessaTrainState.create(jv, tx)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    masks_before = {n: b.clone() for n, b in tm.named_buffers()}
    state = TR.RessaTrainState.create(tm, weight_decay=0.05)
    tstep = TR.make_kd_train_step(tm, state.opt, KL_W, T_KD,
                                  accum_grad_iters=accum)
    steps = []
    for _ in range(2):
        # JAX's gradient at the port's LoRA: after one step the two states
        # differ by up to 2.1·lr where Adam divided a near-zero gradient
        jgrads = _jax_grads(grad_fn, jv, _as_tree(jstate.lora, state.lora),
                            jb, accum)
        jstate, jmet = jstep(jstate, jb, LR)
        tmet = tstep({k: _t(v) for k, v in batch.items()}, LR)
        steps.append(dict(
            jmet=jmet, tmet=tmet, jgrads=jgrads,
            tgrads={n: p.grad.numpy().copy()
                    for n, p in state.lora.items()},
            jlora=_lora_leaves(jstate.lora),
            tlora={n: p.detach().numpy().copy()
                   for n, p in state.lora.items()}))
    return dict(steps=steps, tm=tm, before=before,
                masks_before=masks_before,
                lora0=_lora_leaves(variables["lora"]))


@pytest.mark.parametrize("step", [0, 1], ids=["step1", "step2"])
def test_vicuna_kd_metrics_match_jax(two_kd_steps, step):
    s = two_kd_steps["steps"][step]
    for key in ("loss", "ce", "kl"):
        np.testing.assert_allclose(float(s["tmet"][key]),
                                   float(s["jmet"][key]),
                                   atol=1e-4, rtol=1e-4)
    assert float(s["jmet"]["kl"]) > 0   # the seeded adapters move the student


@pytest.mark.parametrize("step", [0, 1], ids=["step1", "step2"])
def test_vicuna_kd_grads_match_jax(two_kd_steps, step):
    s = two_kd_steps["steps"][step]
    jg, tg = s["jgrads"], s["tgrads"]
    # adapted linears: ViT 2 × 4, Q-Former 12 + 8, LLaMA 2 × 7
    assert set(jg) == set(tg) and len(tg) == 2 * (8 + 20 + 14)
    assert any(n.startswith("llm_model.") for n in tg)
    for name, want in jg.items():
        scale = float(np.abs(want).max())
        assert float(np.abs(tg[name] - want).max()) <= 1e-4 * scale, name
    # all but the last Q-Former layer's text FFN (its output leaves the
    # Q-Former at no query position) carry a gradient
    assert sum(float(np.abs(g).max()) > 0 for g in jg.values()) >= 80


def test_vicuna_kd_adamw_updates_match_jax(two_kd_steps):
    steps, lora0 = two_kd_steps["steps"], two_kd_steps["lora0"]
    for k, s in enumerate(steps):
        for name, want in s["jlora"].items():
            got = s["tlora"][name]
            assert not np.array_equal(want, lora0[name]), name
            diff = np.abs(got - want)
            assert diff.max() <= 2.1 * LR * (k + 1), name
            big = np.ones(want.shape, bool)
            for prior in steps[:k + 1]:
                g = prior["jgrads"][name]
                big &= np.abs(g) > 1e-4 * np.abs(g).max()
            assert (diff[big] <= 1e-3 * LR).all(), (name, k)


def test_vicuna_kd_moves_only_lora(two_kd_steps):
    tm, before = two_kd_steps["tm"], two_kd_steps["before"]
    for name, p in tm.named_parameters():
        if name.rsplit(".", 1)[-1] in ("lora_a", "lora_b"):
            assert p.requires_grad and not torch.equal(p, before[name])
        else:
            assert not p.requires_grad and p.grad is None, name
            assert torch.equal(p, before[name]), name
    for name, buf in tm.named_buffers():
        assert torch.equal(buf, two_kd_steps["masks_before"][name]), name


@pytest.mark.parametrize("sparse", [True, False])
def test_vicuna_merge_matches_jax(sparse):
    _, variables, tm, _ = tiny_lora_vicuna(seed=32)
    jv = _jnp(variables)
    want = flatten(JR.merge_lora_into_params(
        jv["params"], jv["masks"], jv["lora"], sparse=sparse, alpha=16.0))
    TR.merge_lora_into_params(tm, sparse=sparse)
    named = dict(tm.named_parameters())
    for path, w in want.items():
        np.testing.assert_allclose(named[".".join(path)].detach().numpy(),
                                   np.asarray(w), atol=1e-6, rtol=1e-6)
    # every adapted LLaMA linear (2 blocks × 7) took its adapter
    orig = flatten(variables["params"])
    assert sum(path[0] == "llm_model" and not np.array_equal(
        np.asarray(w), orig[path]) for path, w in want.items()) == 2 * 7


def test_vicuna_adapter_state_covers_llm_model(tmp_path):
    _, variables, tm, _ = tiny_lora_vicuna(seed=33)
    state = TP.adapter_state(tm)
    assert set(state) == {"lora", "masks"} and "llm_model" in state["lora"]
    for key in ("lora", "masks"):
        want = flatten(variables[key])
        got = flatten(state[key])
        assert set(got) == set(want), key
        for path, w in want.items():
            np.testing.assert_array_equal(got[path].numpy(), np.asarray(w))
    fresh = TBV.Blip2VicunaInstruct(tiny_lora_vicuna_configs()[1],
                                    device="cpu")
    load_jax_variables(fresh, {"params": variables["params"]}, strict=False)
    TP.attach_adapter_state(
        fresh, TP.load_adapter(TP.save_adapter(tm, str(tmp_path / "a.pt"))))
    for (n1, p1), (n2, p2) in zip(tm.state_dict().items(),
                                  fresh.state_dict().items()):
        assert n1 == n2 and torch.equal(p1, p2), n1


def _samples(rng, b=3, img=28):
    words = ["a", "dog", "on", "the", "grass", "two", "men", "riding",
             "bikes", "what", "is", "this", "red", "car"]
    return {"image": rng.standard_normal((b, img, img, 3)).astype(np.float32),
            "text_input": [" ".join(rng.choice(words, 2 + 2 * i))
                           for i in range(b)],
            "text_output": [" ".join(rng.choice(words, 1 + i))
                            for i in range(b)]}


@pytest.mark.parametrize("kind,prompt,with_output", [
    ("t5", "", True), ("t5", "Question: ", False),
    ("vicuna", "", True), ("vicuna", "Question: ", False)])
def test_batch_preparers_match_jax(kind, prompt, with_output):
    rng = np.random.default_rng(34)
    samples = _samples(rng)
    if not with_output:
        del samples["text_output"]
    make = f"make_{kind}_batch_preparer"
    toks = {}
    for side, mod in (("jax", JTok), ("torch", TTok)):
        toks[side] = dict(tokenizer=mod.SimpleTokenizer(
            96, eos_token_id=2, bos_token_id=1),
            qformer_tokenizer=mod.SimpleTokenizer(64))
    want = getattr(JPrep, make)(**toks["jax"], max_txt_len=5,
                                max_output_len=3, prompt=prompt)(samples)
    got = getattr(TPrep, make)(**toks["torch"], max_txt_len=5,
                               max_output_len=3, prompt=prompt)(samples)
    assert set(got) == set(want)
    for key, w in want.items():
        assert isinstance(got[key], np.ndarray), key
        assert got[key].dtype == np.asarray(w).dtype, key
        np.testing.assert_array_equal(got[key], np.asarray(w), err_msg=key)
    if kind == "vicuna":
        assert (got["text_input_ids"][:, 0] == 1).all()   # BOS first
        assert (got["labels"] == -100).any()
