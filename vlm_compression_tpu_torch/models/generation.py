"""Autoregressive decoding: greedy, nucleus sampling, beam search (port of
``vlm_compression_tpu/models/generation.py``; speculative decoding comes
later).

Every entry point drives a ``step_fn(tokens, cache) -> (logits, cache)``
closure; ``make_t5_step`` builds it for ``T5ForConditionalGeneration``.
The JAX package's ``lax.while_loop`` becomes a Python loop with the same
early stop.  Semantics matched to HF, as there:

  * repetition penalty divides positive / multiplies negative logits of
    tokens already generated;
  * length penalty: finished score = sum-logprob / len**penalty;
  * min_length: NEG_INF added to the EOS logit below min length;
  * beam search applies the processors AFTER log_softmax (HF order).

Top-k selections sort stably (ties → lowest index first), as XLA's top_k.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG_INF = -1.0e7


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_length: int = 32
    min_length: int = 1
    num_beams: int = 1
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    top_p: float = 0.9
    temperature: float = 1.0
    decoder_start_token_id: int = 0
    eos_token_id: int = 1
    pad_token_id: int = 0
    do_sample: bool = False


# ---------------------------------------------------------------------------
# logits processors
# ---------------------------------------------------------------------------


def apply_repetition_penalty(logits, seqs, valid, penalty: float):
    """logits (..., V); seqs (..., L) token ids; valid (..., L) bool."""
    if penalty == 1.0:
        return logits
    lead, v = logits.shape[:-1], logits.shape[-1]
    flat_logits = logits.reshape(-1, v)
    valid = valid & (seqs >= 0)   # negative start sentinels penalize nothing
    flat_seqs = seqs.reshape(-1, seqs.shape[-1])
    flat_valid = valid.expand(seqs.shape).reshape(-1, seqs.shape[-1])
    present = torch.zeros_like(flat_logits)
    present.scatter_reduce_(1, flat_seqs.clamp(0, v - 1).long(),
                            flat_valid.to(present.dtype), reduce="amax")
    penalized = torch.where(flat_logits > 0, flat_logits / penalty,
                            flat_logits * penalty)
    return torch.where(present > 0, penalized, flat_logits).reshape(*lead, v)


def mask_min_length(logits, cur_len: int, min_length: int, eos_token_id: int):
    """Force EOS out while below min_length (cur_len = #generated so far)."""
    if cur_len < min_length:
        logits = logits.clone()
        logits[..., eos_token_id] += NEG_INF
    return logits


def top_p_filter(logits, top_p: float):
    """Nucleus filtering: keep the smallest set with cumprob ≥ top_p."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < top_p
    inf = torch.full((), float("inf"), dtype=logits.dtype, device=logits.device)
    thr = torch.where(keep_sorted, sorted_logits, inf).min(-1, keepdim=True).values
    return torch.where(logits >= thr, logits,
                       torch.full((), NEG_INF, dtype=logits.dtype,
                                  device=logits.device))


def _top_k(x, k: int):
    """Largest k along the last axis, ties → lowest index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# greedy / sampling
# ---------------------------------------------------------------------------


def greedy_generate(step_fn, cache, batch_size: int, cfg: GenerationConfig,
                    device=None, generator: Optional[torch.Generator] = None):
    """Returns (sequences (b, max_length), lengths).  Sequences start with
    decoder_start and are pad-filled after EOS."""
    L = cfg.max_length
    seqs = torch.full((batch_size, L), cfg.pad_token_id, dtype=torch.int32,
                      device=device)
    seqs[:, 0] = cfg.decoder_start_token_id
    finished = torch.zeros(batch_size, dtype=torch.bool, device=device)
    pos = torch.arange(L, device=device)[None, :]
    i = 1
    while i < L and not bool(finished.all()):
        logits, cache = step_fn(seqs[:, i - 1:i], cache)
        logits = logits[:, -1, :].float()
        logits = apply_repetition_penalty(logits, seqs, pos < i,
                                          cfg.repetition_penalty)
        logits = mask_min_length(logits, i, cfg.min_length, cfg.eos_token_id)
        if cfg.do_sample:
            filtered = top_p_filter(logits / cfg.temperature, cfg.top_p)
            nxt = torch.multinomial(torch.softmax(filtered, dim=-1), 1,
                                    generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = torch.where(finished, torch.full_like(nxt, cfg.pad_token_id),
                          nxt).to(torch.int32)
        seqs[:, i] = nxt
        finished = finished | (nxt == cfg.eos_token_id)
        i += 1
    return seqs, (seqs != cfg.pad_token_id).sum(-1)


# ---------------------------------------------------------------------------
# beam search
# ---------------------------------------------------------------------------


def _gather_beams(cache: dict, beam_idx, batch_size: int, num_beams: int):
    """Reindex the per-beam self-attention caches by beam origin.  The
    cross-attention k/v rows of one request are identical across its
    beams, so they stay as they are."""
    flat_idx = (torch.arange(batch_size, device=beam_idx.device)[:, None]
                * num_beams + beam_idx).reshape(-1)
    for layer in cache["layers"]:
        for key in ("key", "value"):
            layer["self"][key] = layer["self"][key][flat_idx]
    return cache


def beam_search(step_fn, cache, batch_size: int, cfg: GenerationConfig,
                device=None):
    """Returns (best sequences (b, max_length), best scores (b,)).  The
    cache's rows must already be beam-tiled (b * num_beams)."""
    K, L = cfg.num_beams, cfg.max_length
    f32 = dict(dtype=torch.float32, device=device)
    seqs = torch.full((batch_size, K, L), cfg.pad_token_id, dtype=torch.int32,
                      device=device)
    seqs[:, :, 0] = cfg.decoder_start_token_id
    # only beam 0 is live initially — the others duplicate it
    live_scores = torch.tensor([0.0] + [NEG_INF] * (K - 1), **f32
                               ).repeat(batch_size, 1)
    fin_seqs = torch.zeros_like(seqs)
    fin_scores = torch.full((batch_size, K), NEG_INF, **f32)
    pos = torch.arange(L, device=device)[None, None, :]

    def improvable(i):
        if cfg.length_penalty > 0:
            best = live_scores / (L ** cfg.length_penalty)
        else:
            best = live_scores / (i ** cfg.length_penalty)
        return bool((best.max(-1).values > fin_scores.min(-1).values).any())

    i = 1
    while i < L and improvable(i):
        logits, cache = step_fn(seqs[:, :, i - 1].reshape(-1, 1), cache)
        logits = logits[:, -1, :].float().reshape(batch_size, K, -1)
        V = logits.shape[-1]
        logp = torch.log_softmax(logits, dim=-1)
        logp = apply_repetition_penalty(logp, seqs, pos < i,
                                        cfg.repetition_penalty)
        logp = mask_min_length(logp, i, cfg.min_length, cfg.eos_token_id)

        cand = live_scores[..., None] + logp                  # (b, K, V)
        top_scores, top_idx = _top_k(cand.reshape(batch_size, K * V), 2 * K)
        beam_origin = torch.div(top_idx, V, rounding_mode="floor")
        token = (top_idx % V).to(torch.int32)

        cand_seqs = torch.gather(
            seqs, 1, beam_origin[..., None].expand(-1, -1, L)).clone()
        cand_seqs[:, :, i] = token

        is_eos = token == cfg.eos_token_id
        lp = torch.tensor(float(i + 1), **f32) ** cfg.length_penalty
        neg = torch.full((), NEG_INF, **f32)
        eos_scores = torch.where(is_eos, top_scores / lp, neg)
        all_fin_scores = torch.cat([fin_scores, eos_scores], dim=1)
        all_fin_seqs = torch.cat([fin_seqs, cand_seqs], dim=1)
        fin_scores, fin_idx = _top_k(all_fin_scores, K)
        fin_seqs = torch.gather(all_fin_seqs, 1,
                                fin_idx[..., None].expand(-1, -1, L))

        live_cand = torch.where(is_eos, neg, top_scores)
        live_scores, live_idx = _top_k(live_cand, K)
        seqs = torch.gather(cand_seqs, 1, live_idx[..., None].expand(-1, -1, L))
        origin = torch.gather(beam_origin, 1, live_idx)
        cache = _gather_beams(cache, origin, batch_size, K)
        i += 1

    # if nothing finished, fall back to the live beams
    none_fin = (fin_scores == NEG_INF).all(-1)
    lp = torch.tensor(float(i), **f32) ** cfg.length_penalty
    fin_seqs = torch.where(none_fin[:, None, None], seqs, fin_seqs)
    fin_scores = torch.where(none_fin[:, None], live_scores / lp, fin_scores)
    best = torch.argmax(fin_scores, dim=-1)
    out = torch.gather(fin_seqs, 1, best[:, None, None].expand(-1, 1, L))[:, 0]
    return out, fin_scores.max(-1).values


# ---------------------------------------------------------------------------
# T5 wiring
# ---------------------------------------------------------------------------


def make_t5_step(model, enc_out, enc_mask, mode: str = "masked",
                 max_decode_len: int = 32):
    """Build (step_fn, cache) for ``T5ForConditionalGeneration``.

    enc_out/enc_mask may already be beam-tiled; the cache holds empty
    self-attention buffers of ``max_decode_len`` slots and the
    cross-attention k/v of ``enc_out`` (projected once)."""
    cache = model.decoder.init_cache(enc_out, max_decode_len, mode)

    def step_fn(tokens, cache):
        logits = model.decode(tokens, enc_out, None, enc_mask, mode=mode,
                              cache=cache)
        return logits, cache

    return step_fn, cache
