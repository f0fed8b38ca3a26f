"""The PEFT tuners beside LoRA: prompt, prefix and bottleneck (port of
``vlm_compression_tpu/compression/tuners.py``).

  * ``PromptTuning``: ``num_virtual_tokens`` learned embeddings put in
    front of ``inputs_embeds`` (and ones in front of the attention mask);
  * ``PrefixTuning``: per-layer key / value prefixes from a two-layer MLP
    (tanh between) over the prefix embeddings — or one product without
    ``prefix_projection`` — returned as (layers, 2, b, tokens, heads,
    head_dim);
  * ``BottleneckAdapter``: down-project, a nonlinearity (``gelu`` is the
    tanh approximation, Flax's default), up-project, added back scaled.

Nothing in either package consumes them; they are ``nn.Module``s with the
JAX modules' parameter names and layouts (a ``Dense`` kernel is (in,
out)), so the weight bridge carries a JAX tree over.  Parameters start at
N(0, 0.02) (biases at zero) from a generator seeded with ``seed``, on the
card unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike, resolve_device
from vlm_compression_tpu_torch.models.layers import Embed, gelu


def _init_(module: nn.Module, seed: int) -> nn.Module:
    gen = None
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            if gen is None:
                gen = torch.Generator(device=p.device).manual_seed(seed)
            if name.rsplit(".", 1)[-1] == "bias":
                p.zero_()
            else:
                p.normal_(0.0, 0.02, generator=gen)
    return module


class Dense(nn.Module):
    """Flax ``nn.Dense``: y = x · kernel + bias, kernel (in, out)."""

    def __init__(self, in_features: int, features: int, device=None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((in_features, features),
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x):
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


@dataclasses.dataclass(frozen=True)
class PromptTuningConfig:
    num_virtual_tokens: int = 20
    token_dim: int = 768


class PromptTuning(nn.Module):
    def __init__(self, cfg: PromptTuningConfig, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.prompt_embeddings = nn.Parameter(torch.empty(
            (cfg.num_virtual_tokens, cfg.token_dim),
            device=resolve_device(device)))
        _init_(self, seed)

    def forward(self, inputs_embeds, attention_mask=None):
        b = inputs_embeds.shape[0]
        p = self.prompt_embeddings.to(inputs_embeds.dtype)[None].expand(
            b, -1, -1)
        out = torch.cat([p, inputs_embeds], dim=1)
        if attention_mask is None:
            return out, None
        ones = torch.ones((b, self.cfg.num_virtual_tokens),
                          dtype=attention_mask.dtype,
                          device=attention_mask.device)
        return out, torch.cat([ones, attention_mask], dim=1)


@dataclasses.dataclass(frozen=True)
class PrefixTuningConfig:
    num_virtual_tokens: int = 20
    token_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    encoder_hidden_size: int = 768
    prefix_projection: bool = True


class PrefixTuning(nn.Module):
    """forward(batch_size) → (num_layers, 2, b, tokens, heads, head_dim)."""

    def __init__(self, cfg: PrefixTuningConfig, device: DeviceLike = None,
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        out = cfg.num_layers * 2 * cfg.token_dim
        self.prefix_embedding = Embed(cfg.num_virtual_tokens, cfg.token_dim,
                                      torch.float32, device)
        if cfg.prefix_projection:
            self.proj_in = Dense(cfg.token_dim, cfg.encoder_hidden_size,
                                 device)
            self.proj_out = Dense(cfg.encoder_hidden_size, out, device)
        else:
            self.kv = Dense(cfg.token_dim, out, device)
        _init_(self, seed)

    def forward(self, batch_size: int):
        cfg = self.cfg
        emb = self.prefix_embedding.embedding
        if cfg.prefix_projection:
            kv = self.proj_out(torch.tanh(self.proj_in(emb)))
        else:
            kv = self.kv(emb)
        kv = kv.reshape(cfg.num_virtual_tokens, cfg.num_layers, 2,
                        cfg.num_heads, cfg.token_dim // cfg.num_heads)
        kv = kv.permute(1, 2, 0, 3, 4)               # (L, 2, T, H, D)
        return kv[:, :, None].expand(-1, -1, batch_size, -1, -1, -1)


@dataclasses.dataclass(frozen=True)
class BottleneckConfig:
    bottleneck_size: int = 64
    non_linearity: str = "relu"
    scaling: float = 1.0


_ACTS = {"relu": torch.relu, "gelu": lambda x: gelu(x, approximate=True),
         "tanh": torch.tanh}


class BottleneckAdapter(nn.Module):
    """``features``: the width of the input it adapts (Flax infers it from
    the first call)."""

    def __init__(self, cfg: BottleneckConfig, features: int,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.down = Dense(features, cfg.bottleneck_size, device)
        self.up = Dense(cfg.bottleneck_size, features, device)
        _init_(self, seed)

    def forward(self, x):
        h = _ACTS[self.cfg.non_linearity](self.down(x))
        return x + self.cfg.scaling * self.up(h)
