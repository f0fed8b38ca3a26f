"""Autoregressive decoding: greedy, nucleus sampling, beam search and
speculative decoding (port of ``vlm_compression_tpu/models/generation.py``).

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

from vlm_compression_tpu_torch.models.kvcache import is_per_row

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
    """Reindex every per-row entry of the self-attention caches (k/v, int8
    scales, a per-row index) by beam origin.  The cross-attention k/v rows
    of one request are identical across its beams, so they stay as they
    are."""
    flat_idx = (torch.arange(batch_size, device=beam_idx.device)[:, None]
                * num_beams + beam_idx).reshape(-1)
    for layer in cache["layers"]:
        kv = layer["self"]
        for key, x in kv.items():
            if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                    and x.shape[0] == batch_size * num_beams:
                kv[key] = x[flat_idx]
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


@torch.no_grad()
def t5_generate(model, input_ids=None, attention_mask=None, inputs_embeds=None,
                cfg: Optional[GenerationConfig] = None, mode: str = "masked",
                generator: Optional[torch.Generator] = None):
    """Encode → decode for a bare ``T5ForConditionalGeneration``: beam
    search (num_beams > 1) or greedy / nucleus.  Returns (b, max_length)
    ids starting with the decoder start token."""
    cfg = cfg or GenerationConfig(
        decoder_start_token_id=model.cfg.decoder_start_token_id,
        pad_token_id=model.cfg.pad_token_id)
    enc = model.encode(input_ids, inputs_embeds, attention_mask, mode=mode)
    b, k = enc.shape[0], cfg.num_beams
    if k > 1:
        mask = (attention_mask.repeat_interleave(k, dim=0)
                if attention_mask is not None else None)
        step, cache = make_t5_step(model, enc.repeat_interleave(k, dim=0),
                                   mask, mode, cfg.max_length)
        return beam_search(step, cache, b, cfg, device=enc.device)[0]
    step, cache = make_t5_step(model, enc, attention_mask, mode,
                               cfg.max_length)
    return greedy_generate(step, cache, b, cfg, device=enc.device,
                           generator=generator)[0]


# ---------------------------------------------------------------------------
# speculative decoding (draft and verify)
# ---------------------------------------------------------------------------


def _per_row(cache: dict) -> bool:
    return is_per_row(cache["layers"][0]["self"])


def rollback_cache(cache: dict, idx, bound: Optional[int] = None) -> dict:
    """Set every self-attention cache's write index to ``idx``: an int for
    batch-shared caches, a (b,) tensor for per-row ones (``bound``: its
    largest entry, known on the host).  Stale slots past the index are
    overwritten before any query sees them: slots fill in order from the
    index, and a query sees only the slots up to its own position."""
    for layer in cache["layers"]:
        kv = layer["self"]
        kv["index"] = idx
        if is_per_row(kv):
            kv["bound"] = bound
    return cache


def speculative_max_len(max_length: int, gamma: int, per_row: bool) -> int:
    """Cache slots a speculative decode needs: the last verify chunk may
    run γ past ``max_length``; with per-row caches a finished row stalls at
    most at L − 1 + γ while the draft still writes γ more."""
    return max_length + gamma * (2 if per_row else 1) + 1


def _mask_eos_rows(logits, cur_len, cfg: GenerationConfig):
    """min_length per row: NEG_INF added to the EOS logit where the row's
    ``cur_len`` (≥ 1, a tensor broadcasting to logits[..., 0]) is below
    it."""
    if cfg.min_length <= 1:
        return logits
    logits = logits.clone()
    logits[..., cfg.eos_token_id] += torch.where(
        cur_len < cfg.min_length, NEG_INF, 0.0)
    return logits


@torch.no_grad()
def speculative_generate(draft_step, draft_cache, target_step, target_cache,
                         batch_size: int, cfg: GenerationConfig,
                         gamma: int = 4,
                         generator: Optional[torch.Generator] = None,
                         cache_offset: int = 0, device=None):
    """Draft-and-verify decoding.  The draft proposes ``gamma`` tokens one
    step at a time; the target scores [last, d_1 … d_γ] in ONE chunked
    forward.

    Greedy (``do_sample=False``): the longest prefix on which the target's
    argmax agrees with the draft is committed, plus the target's own next
    token, so the output is the target's greedy sequence whatever the
    draft (the draft only sets how many tokens a verify yields).  Exact
    given deterministic logits: the chunked verify and the single step are
    different launches (another M, other tiles), so on the card a top-2
    gap below bf16 rounding can flip; on the CPU both are exact.

    Sampling (``do_sample``): draft token x ~ q is accepted with probability
    min(1, p(x)/q(x)); the first rejection resamples from norm(max(p − q,
    0)), so each committed token is a sample of the processed target
    distribution p (temperature, top-p and penalties as in
    ``greedy_generate``).  torch's generator, not threefry: the same law
    as the JAX package, other draws.

    Commits are capped at γ a round (no bonus token: the draft cache never
    ingested its last proposal).  Batch-shared caches (an int index)
    advance every row by the minimum commit over the live rows; per-row
    caches (a (b,) index: ``kv_cache_per_row``) each row by its own.  Both
    caches need ``speculative_max_len`` slots past ``cache_offset``, the
    slots already holding a primed prefix.  One host sync a round.

    Returns (sequences (b, max_length), lengths, {"rounds": verify calls,
    "committed": committed tokens summed over rows}).
    """
    if gamma < 1:
        raise ValueError("gamma must be >= 1")
    per_row = _per_row(draft_cache)
    if per_row != _per_row(target_cache):
        raise ValueError("draft and target caches must agree on per-row")
    b, L, G = batch_size, cfg.max_length, gamma
    Lg = speculative_max_len(L, G, per_row)
    seqs = torch.full((b, Lg), cfg.pad_token_id, dtype=torch.int32,
                      device=device)
    seqs[:, 0] = cfg.decoder_start_token_id
    finished = torch.zeros(b, dtype=torch.bool, device=device)
    cur = torch.ones(b, dtype=torch.int64, device=device)
    cur_host, fin_host = [1] * b, [False] * b
    rows = torch.arange(b, device=device)
    jar = torch.arange(G + 1, device=device)
    slots = torch.arange(Lg, device=device)
    rounds = n_committed = 0
    while any(c < L and not f for c, f in zip(cur_host, fin_host)):
        last = seqs.gather(1, cur[:, None] - 1)
        # ---- draft: γ single steps under the autoregressive processors
        # (sampling: its processed distribution q enters the rule)
        d = torch.zeros((b, G), dtype=torch.int32, device=device)
        seqs_h, qs, tok = seqs.clone(), [], last
        for t in range(G):
            logits, draft_cache = draft_step(tok, draft_cache)
            logits = apply_repetition_penalty(
                logits[:, -1, :].float(), seqs_h,
                slots[None, :] < (cur + t)[:, None], cfg.repetition_penalty)
            logits = _mask_eos_rows(logits, cur + t, cfg)
            if cfg.do_sample:
                q = torch.softmax(top_p_filter(logits / cfg.temperature,
                                               cfg.top_p), dim=-1)
                nxt = torch.multinomial(q, 1, generator=generator)[:, 0]
                qs.append(q)
            else:
                nxt = torch.argmax(logits, dim=-1)
            d[:, t] = nxt.to(torch.int32)
            seqs_h[rows, cur + t] = d[:, t]
            tok = d[:, t:t + 1]

        # ---- verify: one chunked target forward over [last, d_1..d_γ]
        tlogits, target_cache = target_step(torch.cat([last, d], dim=1),
                                            target_cache)
        qpos = cur[:, None] + jar[None, :]                    # (b, G+1)
        tlogits = apply_repetition_penalty(
            tlogits.float(), seqs_h[:, None, :].expand(b, G + 1, Lg),
            slots[None, None, :] < qpos[..., None], cfg.repetition_penalty)
        tlogits = _mask_eos_rows(tlogits, qpos, cfg)
        if cfg.do_sample:
            qd = torch.stack(qs, dim=1)                       # (b, G, V)
            pd = torch.softmax(top_p_filter(tlogits[:, :G] / cfg.temperature,
                                            cfg.top_p), dim=-1)
            di = d[..., None].long()
            p_at, q_at = pd.gather(-1, di)[..., 0], qd.gather(-1, di)[..., 0]
            u = torch.rand((b, G), generator=generator, device=device)
            acc = (u * q_at.clamp(min=1e-20) < p_at).to(torch.int32)
            k = torch.cumprod(acc, dim=1).sum(1)
            res = (pd - qd).clamp(min=0.0)
            res_sum = res.sum(-1, keepdim=True)
            res = torch.where(res_sum > 0, res / res_sum, pd)
            r = torch.multinomial(res.reshape(b * G, -1), 1,
                                  generator=generator).reshape(b, G)
            mixed = torch.where(jar[None, :G] == k[:, None], r.to(d.dtype), d)
            t_tok = torch.cat([mixed, torch.full(
                (b, 1), cfg.pad_token_id, dtype=d.dtype, device=device)], 1)
        else:
            t_tok = torch.argmax(tlogits, dim=-1).to(torch.int32)
            match = (t_tok[:, :G] == d).to(torch.int32)
            k = torch.cumprod(match, dim=1).sum(1)            # (b,)

        # per-row commit: k accepted + the target's token, capped at γ;
        # finished rows (and, per row, rows past L) commit nothing
        done = finished | (cur >= L) if per_row else finished
        n = torch.where(done, 0, torch.clamp(k + 1, max=G))
        if not per_row:
            n = torch.where(done, G, n).min().expand(b)
        eos_hit = (t_tok == cfg.eos_token_id).to(torch.int32)
        fin_before = finished[:, None] | (torch.cumsum(eos_hit, 1)
                                          - eos_hit > 0)
        committed = torch.where(fin_before, cfg.pad_token_id, t_tok)
        take = jar[None, :] < n[:, None]
        seqs.scatter_(1, qpos, torch.where(take, committed,
                                           seqs.gather(1, qpos)))
        finished = finished | (take & (committed == cfg.eos_token_id)).any(1)
        host = torch.cat([n, finished.to(n.dtype)]).tolist()  # the sync
        fin_host = [bool(f) for f in host[b:]]
        cur_host = [c + m for c, m in zip(cur_host, host[:b])]
        cur = cur + n
        # roll both caches back to the committed frontier (past the primed
        # prefix: rewinding into it would be fatal)
        bound = cache_offset + max(cur_host) - 1
        idx = cache_offset + cur - 1 if per_row else bound
        rollback_cache(draft_cache, idx, bound)
        rollback_cache(target_cache, idx, bound)
        rounds += 1
        n_committed += sum(host[:b])
    seqs = seqs[:, :L]
    lengths = (seqs != cfg.pad_token_id).sum(-1)
    return seqs, lengths, {"rounds": rounds, "committed": n_committed}


def _same_shape(a, b) -> bool:
    """Two tower configs that differ at most in their KV-cache storage."""
    neutral = dict(kv_cache_int8=False, kv_cache_per_row=False)
    return dataclasses.replace(a, **neutral) == dataclasses.replace(
        b, **neutral)


def _check_draft(model, draft_model):
    if draft_model.cfg.vocab_size != model.cfg.vocab_size:
        raise ValueError("draft/target vocab mismatch: "
                         f"{draft_model.cfg.vocab_size} vs "
                         f"{model.cfg.vocab_size}")
    if draft_model.cfg.kv_cache_per_row != model.cfg.kv_cache_per_row:
        raise ValueError("draft and target must agree on kv_cache_per_row")


@torch.no_grad()
def t5_speculative_generate(model, input_ids=None, attention_mask=None,
                            inputs_embeds=None,
                            cfg: Optional[GenerationConfig] = None,
                            draft_mode: str = "masked",
                            target_mode: str = "dense", gamma: int = 4,
                            generator: Optional[torch.Generator] = None,
                            draft_model=None):
    """Speculative T5 generate: the compressed student (``draft_mode``)
    drafts, the dense teacher (``target_mode``) verifies; the output is
    greedy ``t5_generate`` under ``target_mode``.

    ``draft_model``: another T5 of the same vocabulary.  One of the same
    shape (e.g. an int8 copy from ``ops.quant.quantize_model_int8_``)
    decodes against the target's encoding (one encoder pass); a smaller
    one runs its own encoder over ``input_ids``.  Returns (sequences,
    lengths, stats) as ``speculative_generate``."""
    cfg = cfg or GenerationConfig(
        decoder_start_token_id=model.cfg.decoder_start_token_id,
        pad_token_id=model.cfg.pad_token_id)
    draft = model if draft_model is None else draft_model
    own = not _same_shape(draft.cfg, model.cfg)
    if draft_model is not None:
        _check_draft(model, draft_model)
        if own and input_ids is None:
            # inputs_embeds live in the TARGET's d_model
            raise ValueError("heterogeneous draft needs input_ids")
    enc = model.encode(input_ids, inputs_embeds, attention_mask,
                       mode=target_mode)
    max_len = speculative_max_len(cfg.max_length, gamma,
                                  model.cfg.kv_cache_per_row)
    d_enc = (draft.encode(input_ids, None, attention_mask, mode=draft_mode)
             if own else enc)
    dstep, dcache = make_t5_step(draft, d_enc, attention_mask, draft_mode,
                                 max_len)
    tstep, tcache = make_t5_step(model, enc, attention_mask, target_mode,
                                 max_len)
    return speculative_generate(dstep, dcache, tstep, tcache, enc.shape[0],
                                cfg, gamma=gamma, generator=generator,
                                device=enc.device)


def with_start(step_fn, start):
    """A step that feeds each row's ``start`` token where the loop holds
    the -1 start sentinel (never an embedding index)."""
    def f(tokens, cache):
        return step_fn(torch.where(tokens == -1, start[:, None], tokens),
                       cache)
    return f


@torch.no_grad()
def causal_speculative_generate(model, prompt_input_ids,
                                prompt_attention_mask=None,
                                cfg: Optional[GenerationConfig] = None,
                                gamma: int = 4,
                                generator: Optional[torch.Generator] = None,
                                target_mode: str = "dense",
                                draft_mode: str = "masked",
                                draft_model=None):
    """Speculative decoding for a bare ``LlamaForCausalLM``: the prompt
    minus its last token primes both caches (the draft embeds it through
    its own table), the last token seeds the loop; the output is the
    target's greedy sequence, its first column that last token.
    ``draft_model``: another causal LM of the same vocabulary (a smaller
    one, or a same-shape copy)."""
    from vlm_compression_tpu_torch.models.llama import make_causal_step

    cfg = cfg or GenerationConfig()
    draft = model if draft_model is None else draft_model
    if draft_model is not None:
        _check_draft(model, draft_model)
    max_len = speculative_max_len(cfg.max_length, gamma,
                                  model.cfg.kv_cache_per_row)
    start = prompt_input_ids[:, -1].to(torch.int32)
    mask = (prompt_attention_mask[:, :-1].to(torch.int32)
            if prompt_attention_mask is not None else None)

    def prime(m, mode):
        emb = m.embed_tokens(prompt_input_ids[:, :-1])
        return make_causal_step(m, emb, mask, mode=mode,
                                max_decode_len=max_len)

    dstep, dcache = prime(draft, draft_mode)
    tstep, tcache = prime(model, target_mode)
    seqs, lengths, stats = speculative_generate(
        with_start(dstep, start), dcache, with_start(tstep, start), tcache,
        start.shape[0], dataclasses.replace(cfg, decoder_start_token_id=-1),
        gamma=gamma, generator=generator,
        cache_offset=prompt_input_ids.shape[1] - 1, device=start.device)
    seqs[:, 0] = start
    return seqs, lengths, stats
