"""The port's checkpoint converters (``models/convert.py``) vs the JAX
package's on the CPU, on seeded synthetic state dicts in the HF / LAVIS key
layouts (no checkpoint is in the repository, and ``transformers`` is not
used).

Each converter's state dict equals, name for name and bit for bit, the
JAX converter's tree carried into a port model of the same tiny fp32
config by ``models/bridge.load_jax_variables(strict=True)``, and loads
into that model with strict keys; ``cast_tree`` casts as JAX's does, bit
for bit; ``load_torch_state_dict`` reads a ``.pth`` (a LAVIS ``model``
entry too) as JAX's does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import F32, port_config
from vlm_compression_tpu.models import blip2_t5_instruct as JB
from vlm_compression_tpu.models import blip2_vicuna_instruct as JBV
from vlm_compression_tpu.models import convert as JC
from vlm_compression_tpu.models import eva_vit as JV
from vlm_compression_tpu.models import llama as JL
from vlm_compression_tpu.models import opt as JO
from vlm_compression_tpu.models import qformer as JQ
from vlm_compression_tpu.models import t5 as JT
from vlm_compression_tpu_torch.models import blip2_t5_instruct as TB
from vlm_compression_tpu_torch.models import blip2_vicuna_instruct as TBV
from vlm_compression_tpu_torch.models import convert as TC
from vlm_compression_tpu_torch.models import eva_vit as TV
from vlm_compression_tpu_torch.models import llama as TL
from vlm_compression_tpu_torch.models import opt as TO
from vlm_compression_tpu_torch.models import qformer as TQ
from vlm_compression_tpu_torch.models import t5 as TT
from vlm_compression_tpu_torch.models.bridge import (
    flatten,
    load_jax_variables,
    to_torch,
)


class _Draw:
    """A seeded HF-layout state dict, one entry at a time."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.sd = {}

    def __call__(self, name, *shape):
        self.sd[name] = self.rng.standard_normal(shape).astype(np.float32)

    def linear(self, name, out, inp, bias=True):
        self(name + ".weight", out, inp)
        if bias:
            self(name + ".bias", out)

    def norm(self, name, d, bias=True):
        self(name + ".weight", d)
        if bias:
            self(name + ".bias", d)


def hf_t5(draw, cfg, prefix=""):
    d, inner, ff = cfg.d_model, cfg.num_heads * cfg.d_kv, cfg.d_ff
    draw(prefix + "shared.weight", cfg.vocab_size, d)
    draw(prefix + "lm_head.weight", cfg.vocab_size, d)
    for stack, n in (("encoder", cfg.num_layers),
                     ("decoder", cfg.num_decoder_layers)):
        s = f"{prefix}{stack}."
        draw(s + "final_layer_norm.weight", d)
        draw(s + "block.0.layer.0.SelfAttention.relative_attention_bias."
             "weight", cfg.relative_attention_num_buckets, cfg.num_heads)
        for i in range(n):
            b = f"{s}block.{i}.layer."
            attn = [("0.SelfAttention", "0")]
            if stack == "decoder":
                attn.append(("1.EncDecAttention", "1"))
            for name, ln in attn:
                for k in ("q", "k", "v"):
                    draw.linear(f"{b}{name}.{k}", inner, d, bias=False)
                draw.linear(f"{b}{name}.o", d, inner, bias=False)
                draw(f"{b}{ln}.layer_norm.weight", d)
            j = 2 if stack == "decoder" else 1
            draw.linear(f"{b}{j}.DenseReluDense.wi_0", ff, d, bias=False)
            draw.linear(f"{b}{j}.DenseReluDense.wi_1", ff, d, bias=False)
            draw.linear(f"{b}{j}.DenseReluDense.wo", d, ff, bias=False)
            draw(f"{b}{j}.layer_norm.weight", d)


def hf_eva_vit(draw, cfg, prefix=""):
    D, p = cfg.embed_dim, cfg.patch_size
    draw(prefix + "cls_token", 1, 1, D)
    draw(prefix + "pos_embed", 1, cfg.num_patches + 1, D)
    draw.linear(prefix + "patch_embed.proj", D, 3 * p * p)
    draw.sd[prefix + "patch_embed.proj.weight"] = \
        draw.sd[prefix + "patch_embed.proj.weight"].reshape(D, 3, p, p)
    for i in range(cfg.depth):
        b = f"{prefix}blocks.{i}."
        draw.norm(b + "norm1", D)
        draw.norm(b + "norm2", D)
        draw.linear(b + "attn.qkv", 3 * D, D, bias=False)
        draw(b + "attn.q_bias", D)
        draw(b + "attn.v_bias", D)
        draw.linear(b + "attn.proj", D, D)
        draw.linear(b + "mlp.fc1", cfg.mlp_hidden_dim, D)
        draw.linear(b + "mlp.fc2", D, cfg.mlp_hidden_dim)


def hf_qformer(draw, cfg, prefix="bert."):
    h, inter = cfg.hidden_size, cfg.intermediate_size
    e = prefix + "embeddings."
    draw(e + "word_embeddings.weight", cfg.vocab_size, h)
    draw(e + "position_embeddings.weight", cfg.max_position_embeddings, h)
    draw.norm(e + "LayerNorm", h)
    for i in range(cfg.num_layers):
        b = f"{prefix}encoder.layer.{i}."
        kinds = ["attention"]
        if i % cfg.cross_attention_freq == 0:
            kinds.append("crossattention")
        for kind in kinds:
            kv_in = cfg.encoder_width if kind == "crossattention" else h
            draw.linear(b + kind + ".self.query", h, h)
            draw.linear(b + kind + ".self.key", h, kv_in)
            draw.linear(b + kind + ".self.value", h, kv_in)
            draw.linear(b + kind + ".output.dense", h, h)
            draw.norm(b + kind + ".output.LayerNorm", h)
        for inner, out in (("intermediate_query", "output_query"),
                           ("intermediate", "output")):
            draw.linear(b + inner + ".dense", inter, h)
            draw.linear(b + out + ".dense", h, inter)
            draw.norm(b + out + ".LayerNorm", h)


def hf_llama(draw, cfg, prefix="model."):
    d, inter = cfg.hidden_size, cfg.intermediate_size
    draw(prefix + "embed_tokens.weight", cfg.vocab_size, d)
    draw(prefix + "norm.weight", d)
    draw(("llm_model." if prefix.startswith("llm_model.") else "")
         + "lm_head.weight", cfg.vocab_size, d)
    for i in range(cfg.num_layers):
        b = f"{prefix}layers.{i}."
        draw(b + "input_layernorm.weight", d)
        draw(b + "post_attention_layernorm.weight", d)
        for k in ("q_proj", "k_proj", "v_proj", "o_proj"):
            draw.linear(b + "self_attn." + k, d, d, bias=False)
        draw.linear(b + "mlp.gate_proj", inter, d, bias=False)
        draw.linear(b + "mlp.up_proj", inter, d, bias=False)
        draw.linear(b + "mlp.down_proj", d, inter, bias=False)


def hf_opt(draw, cfg, prefix="model.decoder."):
    d, ff = cfg.hidden_size, cfg.ffn_dim
    draw(prefix + "embed_tokens.weight", cfg.vocab_size, d)
    draw(prefix + "embed_positions.weight", cfg.max_position_embeddings + 2,
         d)
    draw.norm(prefix + "final_layer_norm", d)
    draw("lm_head.weight", cfg.vocab_size, d)
    for i in range(cfg.num_layers):
        b = f"{prefix}layers.{i}."
        draw.norm(b + "self_attn_layer_norm", d)
        draw.norm(b + "final_layer_norm", d)
        for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
            draw.linear(b + "self_attn." + k, d, d)
        draw.linear(b + "fc1", ff, d)
        draw.linear(b + "fc2", d, ff)


def _carried(model, tree):
    """The JAX converter's tree in the port model's state dict."""
    load_jax_variables(model, {"params": tree}, strict=True)
    return model.state_dict()


def _assert_same(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


def _check(got, model, tree):
    _assert_same(got, _carried(model, tree))
    model.load_state_dict(got, strict=True)


def test_convert_t5_matches_jax():
    jcfg = JT.T5Config.tiny(**F32)
    tcfg = port_config(jcfg, TT.T5Config)
    draw = _Draw(1)
    hf_t5(draw, tcfg)
    args = (tcfg.num_layers, tcfg.num_decoder_layers)
    _check(TC.convert_t5(draw.sd, *args),
           TT.T5ForConditionalGeneration(tcfg, device="cpu"),
           JC.convert_t5(draw.sd, *args))


def test_convert_eva_vit_matches_jax():
    tcfg = port_config(JV.EvaViTConfig.tiny(**F32), TV.EvaViTConfig)
    draw = _Draw(2)
    hf_eva_vit(draw, tcfg)
    _check(TC.convert_eva_vit(draw.sd, tcfg.depth),
           TV.EvaViT(tcfg, device="cpu"),
           JC.convert_eva_vit(draw.sd, tcfg.depth))


@pytest.mark.parametrize("prefix", ["bert.", ""])
def test_convert_qformer_matches_jax(prefix):
    tcfg = port_config(JQ.QFormerConfig.tiny(dtype="float32"),
                       TQ.QFormerConfig)
    draw = _Draw(3)
    hf_qformer(draw, tcfg, prefix)
    draw("query_tokens", 1, tcfg.num_query_tokens, tcfg.hidden_size)
    qt = draw.sd.pop("query_tokens")
    args = (tcfg.num_layers, tcfg.cross_attention_freq, qt)
    _check(TC.convert_qformer(draw.sd, *args),
           TQ.QFormer(tcfg, device="cpu"),
           JC.convert_qformer(draw.sd, *args))


@pytest.mark.parametrize("prefix", ["model.", ""])
def test_convert_llama_matches_jax(prefix):
    tcfg = port_config(JL.LlamaConfig.tiny(**F32), TL.LlamaConfig)
    draw = _Draw(4)
    hf_llama(draw, tcfg, prefix)
    _check(TC.convert_llama(draw.sd, tcfg.num_layers),
           TL.LlamaForCausalLM(tcfg, device="cpu"),
           JC.convert_llama(draw.sd, tcfg.num_layers))


@pytest.mark.parametrize("prefix", ["model.decoder.", "decoder.", "model."])
def test_convert_opt_matches_jax(prefix):
    tcfg = port_config(JO.OPTConfig.tiny(**F32), TO.OPTConfig)
    draw = _Draw(5)
    hf_opt(draw, tcfg, prefix)
    _check(TC.convert_opt(draw.sd, tcfg.num_layers),
           TO.OPTForCausalLM(tcfg, device="cpu"),
           JO.convert_opt(draw.sd, tcfg.num_layers))


def _instructblip_sd(cfg, seed, llm: str):
    draw = _Draw(seed)
    hf_eva_vit(draw, cfg.vit, "visual_encoder.")
    draw.norm("ln_vision", cfg.vit.embed_dim)
    hf_qformer(draw, cfg.qformer, "Qformer.bert.")
    # LAVIS's Q-Former carries its (unused) LM head: not converted
    draw("Qformer.cls.predictions.bias", cfg.qformer.vocab_size)
    draw("query_tokens", 1, cfg.qformer.num_query_tokens,
         cfg.qformer.hidden_size)
    if llm == "t5":
        draw.linear("t5_proj", cfg.t5.d_model, cfg.qformer.hidden_size)
        hf_t5(draw, cfg.t5, "t5_model.")
    else:
        draw.linear("llm_proj", cfg.llm.hidden_size, cfg.qformer.hidden_size)
        hf_llama(draw, cfg.llm, "llm_model.model.")
    return draw.sd


@pytest.mark.parametrize("llm", ["t5", "llama"])
def test_convert_instructblip_matches_jax(llm):
    if llm == "t5":
        jcfg = JB.Blip2T5InstructConfig.tiny(
            vit=JV.EvaViTConfig.tiny(**F32),
            qformer=JQ.QFormerConfig.tiny(dtype="float32"),
            t5=JT.T5Config.tiny(d_model=16, **F32))
        tcfg = TB.Blip2T5InstructConfig(
            vit=port_config(jcfg.vit, TV.EvaViTConfig),
            qformer=port_config(jcfg.qformer, TQ.QFormerConfig),
            t5=port_config(jcfg.t5, TT.T5Config))
        model = TB.Blip2T5Instruct(tcfg, device="cpu")
    else:
        jcfg = JBV.Blip2VicunaInstructConfig.tiny(
            vit=JV.EvaViTConfig.tiny(**F32),
            qformer=JQ.QFormerConfig.tiny(dtype="float32"),
            llm=JL.LlamaConfig.tiny(**F32))
        tcfg = TBV.Blip2VicunaInstructConfig(
            vit=port_config(jcfg.vit, TV.EvaViTConfig),
            qformer=port_config(jcfg.qformer, TQ.QFormerConfig),
            llm=port_config(jcfg.llm, TL.LlamaConfig))
        model = TBV.Blip2VicunaInstruct(tcfg, device="cpu")
    sd = _instructblip_sd(tcfg, 6, llm)
    got = TC.convert_instructblip(sd, tcfg)
    _check(got, model, JC.convert_instructblip(sd, jcfg))
    # a partial checkpoint converts its towers alone
    vit_only = {k: v for k, v in sd.items()
                if k.startswith("visual_encoder.")}
    assert set(TC.convert_instructblip(vit_only, tcfg)) == {
        k for k in got if k.startswith("visual_encoder.")}


def test_converters_take_tensors_and_bfloat16():
    tcfg = port_config(JL.LlamaConfig.tiny(**F32), TL.LlamaConfig)
    draw = _Draw(7)
    hf_llama(draw, tcfg)
    want = TC.convert_llama(draw.sd, tcfg.num_layers)
    as_bf16 = {k: torch.from_numpy(v).bfloat16() for k, v in draw.sd.items()}
    got = TC.convert_llama(as_bf16, tcfg.num_layers)
    for name, w in want.items():
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], w.bfloat16().float()), name


def test_cast_tree_matches_jax():
    tcfg = port_config(JO.OPTConfig.tiny(**F32), TO.OPTConfig)
    draw = _Draw(8)
    hf_opt(draw, tcfg)
    state = TC.convert_opt(draw.sd, tcfg.num_layers)
    state["blocks_0.step"] = torch.arange(3, dtype=torch.int32)

    def jax_dtype(path):
        return None if path[-1] == "scale" else (
            jnp.float16 if path[0] == "lm_head" else jnp.bfloat16)

    def port_dtype(path):
        return None if path[-1] == "scale" else (
            torch.float16 if path[0] == "lm_head" else torch.bfloat16)

    tree = JO.convert_opt(draw.sd, tcfg.num_layers)
    tree["blocks_0"]["step"] = np.arange(3, dtype=np.int32)
    want = {".".join(p): to_torch(np.asarray(v))
            for p, v in flatten(JC.cast_tree(tree, jax_dtype)).items()}
    got = TC.cast_tree(state, port_dtype)
    _assert_same(got, want)
    assert got["final_norm.scale"].dtype == torch.float32
    assert got["lm_head.kernel"].dtype == torch.float16
    assert got["blocks_0.fc1.bias"].dtype == torch.bfloat16
    assert got["blocks_0.step"].dtype == torch.int32
    _assert_same(TC.cast_tree(state), state)


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_torch_state_dict_matches_jax(tmp_path, wrapped):
    sd = {"a.weight": torch.randn(3, 4, generator=torch.Generator()
                                  .manual_seed(0)).bfloat16(),
          "b.bias": torch.arange(4, dtype=torch.float16),
          "c.index": torch.arange(5)}
    path = tmp_path / "ck.pth"
    torch.save({"model": sd, "epoch": 3} if wrapped else sd, path)
    want = JC.load_torch_state_dict(str(path))
    got = TC.load_torch_state_dict(str(path))
    assert set(got) == set(want) == set(sd)
    for k in sd:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k])
