"""Per-block remat (``use_remat``, the reference's ``use_grad_checkpoint``)
in the port vs the JAX package on the CPU: one RESSA KD step of the tiny
float32 InstructBLIP-T5 (EVA-ViT and T5 checkpointed) and InstructBLIP-
Vicuna (EVA-ViT and LLaMA checkpointed) with seeded non-zero lora_b and
random masks, with remat and without.

- In the port the step with remat gives the step without it bit for bit:
  loss, CE, KL and every LoRA gradient (the recompute makes the same calls
  on the same shapes).
- Against JAX's remat'd step (``nn.remat`` on each block): loss, CE, KL
  within atol = rtol = 1e-4 and each LoRA gradient within 1e-4 of its
  leaf's largest entry, the tolerances of ``tests/test_torch_retrain.py``.
- The factory turns ``use_grad_checkpoint`` (or ``use_remat``) into every
  tower's ``use_remat``, as the JAX factory does; the cached decode steps
  never checkpoint; each block of a training forward checkpoints once.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_models import tiny_lora_blip
from test_torch_retrain import _jax_grads as t5_jax_grads
from test_torch_vicuna_retrain import _grad_fn as vicuna_grad_fn
from test_torch_vicuna_retrain import tiny_lora_vicuna
from vlm_compression_tpu.models import blip2_t5_instruct as JBT
from vlm_compression_tpu.models import blip2_vicuna_instruct as JBV
from vlm_compression_tpu.models import factory as JF
from vlm_compression_tpu_torch.models import blip2_t5_instruct as TBT
from vlm_compression_tpu_torch.models import blip2_vicuna_instruct as TBV
from vlm_compression_tpu_torch.models import factory as TF
from vlm_compression_tpu_torch.models import layers as TLy
from vlm_compression_tpu_torch.models import t5 as TT
from vlm_compression_tpu_torch.models.bridge import flatten, load_jax_variables
from vlm_compression_tpu_torch.tasks import retrain as TR

KL_W, T_KD, LR = 0.1, 1.0, 1e-3


def remat(cfg, on: bool = True):
    """``cfg`` with every nested ``use_remat`` set to ``on``."""
    return TF.set_field_everywhere(cfg, "use_remat", on)


def _jnp(tree):
    return jax.tree_util.tree_map(jax.numpy.asarray, tree)


@pytest.fixture
def checkpoints(monkeypatch):
    """Counts the blocks run under ``torch.utils.checkpoint``."""
    calls = []
    real = TLy.checkpoint

    def counting(fn, *a, **kw):
        calls.append(type(fn).__name__)
        return real(fn, *a, **kw)

    monkeypatch.setattr(TLy, "checkpoint", counting)
    return calls


def _port_step(tm, batch):
    """One KD step of the port: its metrics and every LoRA gradient."""
    state = TR.RessaTrainState.create(tm, weight_decay=0.05)
    met = TR.make_kd_train_step(tm, state.opt, KL_W, T_KD)(
        {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}, LR)
    return met, {n: p.grad.clone() for n, p in state.lora.items()}


# (builder, seed, JAX class, port class).  The seeds are the retrain
# tests' (tests/test_torch_retrain.py, tests/test_torch_vicuna_retrain.py),
# at which their tolerance holds: the tiny Q-Former's gradients are
# ill-conditioned at some seeds (at 41 the port's plain T5 step is 2.3e-4
# of a leaf's scale from JAX's plain step, remat or not)
FAMILIES = {
    "t5": (tiny_lora_blip, 21, JBT.Blip2T5Instruct, TBT.Blip2T5Instruct),
    "vicuna": (tiny_lora_vicuna, 31, JBV.Blip2VicunaInstruct,
               TBV.Blip2VicunaInstruct),
}
# the checkpointed blocks of one student forward: EVA-ViT 2, then T5's
# encoder 2 and decoder 2, or LLaMA's 2
BLOCKS = {"t5": ["EvaBlock"] * 2 + ["T5Block"] * 4,
          "vicuna": ["EvaBlock"] * 2 + ["LlamaBlock"] * 2}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def steps(request):
    """The KD step with and without remat in the port, and JAX's remat'd
    gradients, from one set of variables and one batch."""
    family = request.param
    make, seed, jcls, tcls = FAMILIES[family]
    jm, variables, tm, batch = make(seed=seed)
    jm_r = jcls(dataclasses.replace(
        jm.cfg, vit=dataclasses.replace(jm.cfg.vit, use_remat=True),
        **{tower: dataclasses.replace(getattr(jm.cfg, tower), use_remat=True)
           for tower in ("t5", "llm") if hasattr(jm.cfg, tower)}))
    tm_r = tcls(remat(tm.cfg), device="cpu")
    load_jax_variables(tm_r, variables)
    jv, jb = _jnp(variables), _jnp(batch)
    if family == "t5":
        jgrads = t5_jax_grads(jm_r, jv, jb)
    else:
        jgrads = vicuna_grad_fn(jm_r)(jv, jv["lora"], jb)
    jgrads = {".".join(p): np.asarray(v) for p, v in flatten(jgrads).items()}
    plain = _port_step(tm, batch)
    with_remat = _port_step(tm_r, batch)
    return dict(family=family, plain=plain, remat=with_remat,
                jgrads=jgrads, tm_r=tm_r, batch=batch)


def test_remat_step_equals_the_plain_step_bit_for_bit(steps):
    (m0, g0), (m1, g1) = steps["plain"], steps["remat"]
    for key in ("loss", "ce", "kl"):
        assert torch.equal(m0[key], m1[key]), key
    assert set(g0) == set(g1) and len(g0) > 40
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    assert sum(bool(g.abs().max() > 0) for g in g1.values()) > 40


def test_remat_gradients_match_jax_remat(steps):
    jg, tg = steps["jgrads"], steps["remat"][1]
    assert set(jg) == set(tg)
    for name, want in jg.items():
        scale = float(np.abs(want).max())
        got = tg[name].numpy()
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, name


def test_each_block_checkpoints_once_a_training_forward(steps, checkpoints):
    _port_step(steps["tm_r"], steps["batch"])
    assert checkpoints == BLOCKS[steps["family"]]


def test_nothing_checkpoints_without_autograd(steps, checkpoints):
    with torch.no_grad():
        steps["tm_r"](**{k: torch.from_numpy(np.array(v))
                         for k, v in steps["batch"].items()})
    assert checkpoints == []


def test_cached_decode_is_never_checkpointed(checkpoints):
    """The T5 decoder and LLaMA run their cached steps un-checkpointed, as
    JAX's ``_apply_block`` does when decoding, even under autograd."""
    from vlm_compression_tpu_torch.models import llama as TL
    from vlm_compression_tpu_torch.models.bridge import random_init_

    torch.manual_seed(0)
    t5 = random_init_(TT.T5ForConditionalGeneration(
        TT.T5Config.tiny(use_remat=True, **dict(param_dtype="float32",
                                                dtype="float32")),
        device="cpu"))
    with torch.no_grad():
        enc = t5.encode(torch.randint(1, 90, (2, 5)))
        cache = t5.decoder.init_cache(enc, 4)
    llm = random_init_(TL.LlamaForCausalLM(
        TL.LlamaConfig.tiny(use_remat=True, param_dtype="float32",
                            dtype="float32"), device="cpu"))
    lcache = llm.init_cache(2, 6, torch.float32, "cpu")
    with torch.enable_grad():
        t5.decode(torch.zeros((2, 1), dtype=torch.long), enc, cache=cache)
        llm(torch.randint(3, 60, (2, 3)), cache=lcache)
        assert checkpoints == []
        t5.decode(torch.zeros((2, 3), dtype=torch.long), enc)
        llm(torch.randint(3, 60, (2, 3)))
    assert checkpoints == ["T5Block"] * 2 + ["LlamaBlock"] * 2


@pytest.mark.parametrize("node", [dict(use_grad_checkpoint=True),
                                  dict(use_remat=True),
                                  dict(use_grad_checkpoint=False,
                                       use_remat=True),
                                  dict()])
@pytest.mark.parametrize("arch", ["blip2_t5_instruct",
                                  "blip2_vicuna_instruct", "blip2",
                                  "blip2_image_text_matching",
                                  "blip_retrieval", "eva_clip", "t5"])
def test_factory_sets_use_remat_on_every_tower_as_jax_does(arch, node):
    """Every nested config that carries ``use_remat`` gets the JAX
    factory's value; ``use_grad_checkpoint``, when present, decides."""
    node = dict(node, arch=arch, tiny=True)
    _, jcfg = JF.build_model_config(node)
    _, tcfg = TF.build_model_config(node)

    def knobs(cfg, prefix=""):
        out = {}
        for f in dataclasses.fields(cfg):
            v = getattr(cfg, f.name)
            if dataclasses.is_dataclass(v):
                out.update(knobs(v, prefix + f.name + "."))
            elif f.name == "use_remat":
                out[prefix + f.name] = v
        return out

    want, got = knobs(jcfg), knobs(tcfg)
    assert got == want
    on = bool(node.get("use_grad_checkpoint", node.get("use_remat")))
    assert set(got.values()) <= {on}
    # the towers that carry the knob: EVA-ViT, T5, LLaMA
    assert len(got) == {"blip2_t5_instruct": 2, "blip2_vicuna_instruct": 2,
                        "blip_retrieval": 0}.get(arch, 1)


def test_set_remat_switches_a_built_model(steps, checkpoints):
    """``set_remat_`` flips every tower's knob in place (weights kept):
    the plain model then checkpoints as the one built with remat, and
    back."""
    tm = steps["tm_r"]
    TF.set_remat_(tm, False)
    try:
        assert not any(getattr(m.cfg, "use_remat", False)
                       for m in tm.modules() if hasattr(m, "cfg")
                       and dataclasses.is_dataclass(m.cfg))
        _port_step(tm, steps["batch"])
        assert checkpoints == []
        TF.set_remat_(tm, True)
        met, grads = _port_step(tm, steps["batch"])
        assert checkpoints == BLOCKS[steps["family"]]
    finally:
        TF.set_remat_(tm, True)
