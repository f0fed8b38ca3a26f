"""PyTorch (HF / LAVIS) checkpoints → the port's state dicts (port of
``vlm_compression_tpu/models/convert.py`` and of ``convert_opt`` in
``vlm_compression_tpu/models/opt.py``).

Every converter takes a flat ``{name: array}`` state dict in the source's
key layout (numpy arrays or tensors; ``load_torch_state_dict`` reads a
``.pth``) and returns a flat state dict under the port's module names
(``visual_encoder.blocks_0.attn.qkv.kernel``, …), CPU tensors ready for
``model.load_state_dict``.  The port keeps the JAX package's layout, so
the conversions are its:

  * torch ``nn.Linear`` stores (out, in); the port's kernels are (in, out)
    → transposed;
  * torch ``Conv2d`` stores (out, in, kh, kw); the ViT's patch kernel is
    (kh, kw, in, out);
  * T5's ``relative_attention_bias`` lives on block 0 only → the stack's
    ``rel_bias``.

No checkpoint is in the repository, so these run on synthetic state dicts
only (``tests/test_torch_convert.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` state dict (a LAVIS checkpoint's ``model`` entry when it
    holds one), every tensor as float32 on the CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "model" in sd and isinstance(
            sd["model"], dict):
        sd = sd["model"]
    return {k: v.float() if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


def _a(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        # numpy has no bfloat16: widen (exactly) to float32
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _flat(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def _prefixed(state: Dict[str, torch.Tensor], prefix: str):
    return {f"{prefix}.{k}": v for k, v in state.items()}


def _lin(sd, name):
    out = {"kernel": _a(sd[name + ".weight"]).T}
    if name + ".bias" in sd:
        out["bias"] = _a(sd[name + ".bias"])
    return out


def _ln(sd, name):
    out = {"scale": _a(sd[name + ".weight"])}
    if name + ".bias" in sd:
        out["bias"] = _a(sd[name + ".bias"])
    return out


# ---------------------------------------------------------------------------
# T5 (HF modeling_t5 layout)
# ---------------------------------------------------------------------------


def convert_t5(sd, num_layers: int, num_decoder_layers: int,
               tie_word_embeddings: bool = False) -> Dict[str, torch.Tensor]:
    """HF ``T5ForConditionalGeneration`` → ``T5ForConditionalGeneration``."""
    p: Dict = {"shared": {"embedding": _a(sd["shared.weight"])}}
    if not tie_word_embeddings and "lm_head.weight" in sd:
        p["lm_head"] = {"kernel": _a(sd["lm_head.weight"]).T}
    for stack, n, is_dec in (("encoder", num_layers, False),
                             ("decoder", num_decoder_layers, True)):
        out = {"final_norm": {
            "scale": _a(sd[f"{stack}.final_layer_norm.weight"])}}
        rel = (f"{stack}.block.0.layer.0.SelfAttention."
               "relative_attention_bias.weight")
        out["rel_bias"] = {"rel_embedding": _a(sd[rel])}
        for i in range(n):
            b = f"{stack}.block.{i}."
            ffn_j = 2 if is_dec else 1
            blk = {
                "self_attn": {k: _lin(sd, b + f"layer.0.SelfAttention.{k}")
                              for k in ("q", "k", "v", "o")},
                "ln_self": {"scale": _a(sd[b + "layer.0.layer_norm.weight"])},
                "ffn": {k: _lin(sd, b + f"layer.{ffn_j}.DenseReluDense.{k}")
                        for k in ("wi_0", "wi_1", "wo")},
                "ln_ffn": {"scale": _a(
                    sd[b + f"layer.{ffn_j}.layer_norm.weight"])},
            }
            if is_dec:
                blk["cross_attn"] = {
                    k: _lin(sd, b + f"layer.1.EncDecAttention.{k}")
                    for k in ("q", "k", "v", "o")}
                blk["ln_cross"] = {"scale": _a(
                    sd[b + "layer.1.layer_norm.weight"])}
            out[f"blocks_{i}"] = blk
        p[stack] = out
    return _flat(p)


# ---------------------------------------------------------------------------
# EVA ViT-g (LAVIS eva_vit layout)
# ---------------------------------------------------------------------------


def convert_eva_vit(sd, depth: int) -> Dict[str, torch.Tensor]:
    conv_w = _a(sd["patch_embed.proj.weight"])
    p: Dict = {
        "cls_token": _a(sd["cls_token"]),
        "pos_embed": _a(sd["pos_embed"]),
        "patch_embed": {"kernel": np.transpose(conv_w, (2, 3, 1, 0)),
                        "bias": _a(sd["patch_embed.proj.bias"])},
    }
    for i in range(depth):
        b = f"blocks.{i}."
        p[f"blocks_{i}"] = {
            "norm1": _ln(sd, b + "norm1"),
            "norm2": _ln(sd, b + "norm2"),
            "attn": {
                "qkv": {"kernel": _a(sd[b + "attn.qkv.weight"]).T},
                "q_bias": _a(sd[b + "attn.q_bias"]),
                "v_bias": _a(sd[b + "attn.v_bias"]),
                "proj": _lin(sd, b + "attn.proj"),
            },
            "mlp": {"fc1": _lin(sd, b + "mlp.fc1"),
                    "fc2": _lin(sd, b + "mlp.fc2")},
        }
    return _flat(p)


# ---------------------------------------------------------------------------
# Q-Former (BERT layout, LAVIS Qformer.py; a "bert." prefix is stripped)
# ---------------------------------------------------------------------------


def convert_qformer(sd, num_layers: int, cross_attention_freq: int = 2,
                    query_tokens=None) -> Dict[str, torch.Tensor]:
    if any(k.startswith("bert.") for k in sd):
        sd = {**{k[len("bert."):]: v for k, v in sd.items()
                 if k.startswith("bert.")},
              **{k: v for k, v in sd.items() if not k.startswith("bert.")}}
    p: Dict = {
        "word_embeddings": {"embedding": _a(
            sd["embeddings.word_embeddings.weight"])},
        "position_embeddings": {"embedding": _a(
            sd["embeddings.position_embeddings.weight"])},
        "emb_ln": _ln(sd, "embeddings.LayerNorm"),
    }
    if query_tokens is not None:
        qt = _a(query_tokens)
        p["query_tokens"] = qt.reshape(1, *qt.shape[-2:])

    def attention(prefix):
        return {
            "self": {k: _lin(sd, prefix + f".self.{k}")
                     for k in ("query", "key", "value")},
            "output_dense": _lin(sd, prefix + ".output.dense"),
            "output_ln": _ln(sd, prefix + ".output.LayerNorm"),
        }

    def ffn(inter, out):
        return {"intermediate_dense": _lin(sd, inter),
                "output_dense": _lin(sd, out + ".dense"),
                "output_ln": _ln(sd, out + ".LayerNorm")}

    for i in range(num_layers):
        b = f"encoder.layer.{i}"
        layer = {"attention": attention(b + ".attention")}
        if i % cross_attention_freq == 0:
            layer["crossattention"] = attention(b + ".crossattention")
        # the query FFN always; the text FFN where the text branch exists
        layer["ffn_query"] = ffn(b + ".intermediate_query.dense",
                                 b + ".output_query")
        if b + ".intermediate.dense.weight" in sd:
            layer["ffn"] = ffn(b + ".intermediate.dense", b + ".output")
        p[f"layers_{i}"] = layer
    return _flat(p)


# ---------------------------------------------------------------------------
# LLaMA / Vicuna (HF layout)
# ---------------------------------------------------------------------------


def convert_llama(sd, num_layers: int) -> Dict[str, torch.Tensor]:
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items()}
    p: Dict = {
        "embed_tokens": {"embedding": _a(sd["embed_tokens.weight"])},
        "final_norm": {"scale": _a(sd["norm.weight"])},
        "lm_head": {"kernel": _a(sd["lm_head.weight"]).T},
    }
    for i in range(num_layers):
        b = f"layers.{i}."
        p[f"blocks_{i}"] = {
            "input_ln": {"scale": _a(sd[b + "input_layernorm.weight"])},
            "post_attn_ln": {"scale": _a(
                sd[b + "post_attention_layernorm.weight"])},
            "self_attn": {k: _lin(sd, b + f"self_attn.{k}")
                          for k in ("q_proj", "k_proj", "v_proj", "o_proj")},
            "mlp": {k: _lin(sd, b + f"mlp.{k}")
                    for k in ("gate_proj", "up_proj", "down_proj")},
        }
    return _flat(p)


# ---------------------------------------------------------------------------
# OPT (HF OPTForCausalLM layout, "model.decoder." prefix)
# ---------------------------------------------------------------------------


def convert_opt(sd, num_layers: int) -> Dict[str, torch.Tensor]:
    prefixes = ("model.decoder.", "decoder.", "model.")

    def g(k):
        for p in prefixes:
            if p + k in sd:
                return _a(sd[p + k])
        return _a(sd[k])

    def lin(name):
        out = {"kernel": g(name + ".weight").T}
        for p in prefixes + ("",):
            if p + name + ".bias" in sd:
                out["bias"] = _a(sd[p + name + ".bias"])
                break
        return out

    def ln(name):
        return {"scale": g(name + ".weight"), "bias": g(name + ".bias")}

    p: Dict = {
        "embed_tokens": {"embedding": g("embed_tokens.weight")},
        "embed_positions": {"embedding": g("embed_positions.weight")},
        "final_norm": ln("final_layer_norm"),
        "lm_head": {"kernel": _a(sd["lm_head.weight"]).T},
    }
    for i in range(num_layers):
        b = f"layers.{i}."
        p[f"blocks_{i}"] = {
            "self_attn_ln": ln(b + "self_attn_layer_norm"),
            "final_ln": ln(b + "final_layer_norm"),
            "self_attn": {k: lin(b + f"self_attn.{k}")
                          for k in ("q_proj", "k_proj", "v_proj",
                                    "out_proj")},
            "fc1": lin(b + "fc1"),
            "fc2": lin(b + "fc2"),
        }
    return _flat(p)


# ---------------------------------------------------------------------------
# InstructBLIP composite (LAVIS trimmed checkpoints)
# ---------------------------------------------------------------------------


def convert_instructblip(sd, model_cfg) -> Dict[str, torch.Tensor]:
    """A composite ``.pth`` (``visual_encoder.*`` / ``Qformer.*`` /
    ``query_tokens`` / ``t5_proj`` | ``llm_proj`` / ``t5_model.*`` |
    ``llm_model.*``) → the composed model's state dict."""
    def sub(prefix):
        return {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}

    out: Dict[str, torch.Tensor] = {}
    vit_sd = sub("visual_encoder.")
    if vit_sd:
        out.update(_prefixed(convert_eva_vit(vit_sd, model_cfg.vit.depth),
                             "visual_encoder"))
    if "ln_vision.weight" in sd:
        out.update(_flat({"ln_vision": _ln(sd, "ln_vision")}))
    q_sd = sub("Qformer.")
    if q_sd:
        out.update(_prefixed(convert_qformer(
            q_sd, num_layers=model_cfg.qformer.num_layers,
            cross_attention_freq=model_cfg.qformer.cross_attention_freq,
            query_tokens=sd.get("query_tokens")), "qformer"))
    for proj in ("t5_proj", "llm_proj"):
        if proj + ".weight" in sd:
            out.update(_flat({proj: _lin(sd, proj)}))
    t5_sd = sub("t5_model.")
    if t5_sd:
        out.update(_prefixed(convert_t5(
            t5_sd, model_cfg.t5.num_layers, model_cfg.t5.num_decoder_layers,
            model_cfg.t5.tie_word_embeddings), "t5_model"))
    llm_sd = sub("llm_model.")
    if llm_sd:
        out.update(_prefixed(convert_llama(
            llm_sd, num_layers=model_cfg.llm.num_layers), "llm_model"))
    return out


def cast_tree(state: Dict[str, torch.Tensor],
              dtype_for: Optional[Callable[[Tuple[str, ...]],
                                           Optional[torch.dtype]]] = None
              ) -> Dict[str, torch.Tensor]:
    """Cast a converted state dict's float tensors to each tower's param
    dtype: ``dtype_for`` takes a name's path (a tuple of its parts) and
    gives a dtype, or None to leave it."""
    out = {}
    for name, t in state.items():
        t = torch.as_tensor(t)
        if dtype_for is not None and t.is_floating_point():
            dt = dtype_for(tuple(name.split(".")))
            if dt is not None:
                t = t.to(dt)
        out[name] = t
    return out
