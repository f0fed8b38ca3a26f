"""COCO caption metrics (port of
``vlm_compression_tpu/evaluation/caption_metrics.py``), host only: pure
Python, no torch, no device, no nltk.

The scorers follow pycocoevalcap's code path as the JAX package does:

* ``ptb_tokenize``: Penn-Treebank tokenization (``_treebank``, a copy of
  nltk's ``TreebankWordTokenizer`` with ``convert_parentheses=True``),
  lowercased, then pycocoevalcap's punctuation tokens removed;
* ``corpus_bleu``: corpus BLEU-1..4, the "closest" reference length (ties
  to the shorter), precisions smoothed by 1e-15 / 1e-9, brevity penalty
  exp(1 − 1/ratio) iff ratio < 1;
* ``cider_d``: tf-idf over 1..4-grams, idf = log(images) − log(max(df, 1)),
  candidate counts clipped at the reference's, gaussian length penalty
  (σ = 6), ×10, averaged over n and references;
* ``rouge_l``: per image the largest LCS precision and recall over the
  references, F with β = 1.2;
* ``meteor``: exact then Porter-stem matches (``_porter``, a copy of
  nltk's ``PorterStemmer``), the F-mean and fragmentation penalty with the
  constants of ``METEOR_PARAMS`` ("2005" or "1.5en", the Java jar's
  family), the best reference per image;
* SPICE is an explicit ``None`` (the Java scene-graph pipeline cannot
  run), and ``agg_metrics = CIDEr + BLEU-4``, rounded to 4 places.

The copies of nltk's tokenizer and stemmer keep the scores of the JAX
package, which imports nltk, token for token
(``tests/test_torch_caption.py``).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple

from vlm_compression_tpu_torch.evaluation import _porter, _treebank

# the tokens pycocoevalcap's PTBTokenizer wrapper removes
PUNCTUATIONS = frozenset([
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
])


def ptb_tokenize(s: str) -> List[str]:
    """PTB tokens of ``s``, lowercased, punctuation tokens removed."""
    s = s.replace("\n", " ").replace("\r", " ")
    toks = _treebank.tokenize(s)
    return [t.lower() for t in toks if t not in PUNCTUATIONS]


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i: i + n]) for i in range(len(tokens) - n + 1))


# ---------------------------------------------------------------- BLEU

_TINY = 1e-15   # zero correct counts stay about 0 instead of nan
_SMALL = 1e-9


def corpus_bleu(candidates: Dict, references: Dict, max_n: int = 4,
                pre_tokenized: bool = False) -> List[float]:
    """candidates {id: str}, references {id: [str, ...]} →
    [BLEU-1, …, BLEU-max_n], corpus-level."""
    correct = [0] * max_n
    guess = [0] * max_n
    testlen = reflen = 0
    for cid, cand in candidates.items():
        c = cand if pre_tokenized else ptb_tokenize(cand)
        refs = [r if pre_tokenized else ptb_tokenize(r)
                for r in references[cid]]
        testlen += len(c)
        reflen += min((abs(len(r) - len(c)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            cn = _ngrams(c, n)
            max_ref = Counter()
            for r in refs:
                for g, cnt in _ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], cnt)
            guess[n - 1] += max(0, len(c) - n + 1)
            correct[n - 1] += sum(min(cnt, max_ref.get(g, 0))
                                  for g, cnt in cn.items())
    bleus = []
    prod = 1.0
    for k in range(max_n):
        prod *= (correct[k] + _TINY) / (guess[k] + _SMALL)
        bleus.append(prod ** (1.0 / (k + 1)))
    ratio = (testlen + _TINY) / (reflen + _SMALL)
    if ratio < 1:
        bp = math.exp(1 - 1.0 / ratio)
        bleus = [b * bp for b in bleus]
    return bleus


# ------------------------------------------------------------- CIDEr-D


def cider_d(candidates: Dict, references: Dict, max_n: int = 4,
            sigma: float = 6.0, pre_tokenized: bool = False) -> float:
    ids = list(candidates)
    df: List[Dict[Tuple, int]] = [defaultdict(int) for _ in range(max_n)]
    ref_ngrams = {}
    for cid in ids:
        refs = [r if pre_tokenized else ptb_tokenize(r)
                for r in references[cid]]
        ref_ngrams[cid] = refs
        for n in range(max_n):
            seen = set()
            for r in refs:
                seen |= set(_ngrams(r, n + 1))
            for g in seen:
                df[n][g] += 1
    log_docs = math.log(max(len(ids), 1))

    def vec(tokens, n):
        v = {}
        norm = 0.0
        for g, c in _ngrams(tokens, n + 1).items():
            v[g] = c * (log_docs - math.log(max(df[n].get(g, 0), 1)))
            norm += v[g] ** 2
        return v, math.sqrt(norm), len(tokens)

    scores = []
    for cid in ids:
        c = candidates[cid] if pre_tokenized else ptb_tokenize(candidates[cid])
        score_n = [0.0] * max_n
        for n in range(max_n):
            vc, nc, lc = vec(c, n)
            for r in ref_ngrams[cid]:
                vr, nr, lr = vec(r, n)
                num = sum(min(vc[g], vr.get(g, 0.0)) * vr.get(g, 0.0)
                          for g in vc)
                denom = nc * nr
                sim = (num / denom) if denom > 0 else 0.0
                sim *= math.exp(-((lc - lr) ** 2) / (2 * sigma ** 2))
                score_n[n] += sim
            score_n[n] /= max(len(ref_ngrams[cid]), 1)
        scores.append(10.0 * sum(score_n) / max_n)
    return sum(scores) / max(len(scores), 1)


# ------------------------------------------------------------- ROUGE-L


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(cur[-1], prev[j + 1]))
        prev = cur
    return prev[-1]


def rouge_l(candidates: Dict, references: Dict, beta: float = 1.2,
            pre_tokenized: bool = False) -> float:
    """Mean over images of F_beta of the largest LCS precision and recall
    over the references."""
    scores = []
    for cid, cand in candidates.items():
        ct = cand if pre_tokenized else ptb_tokenize(cand)
        precs, recs = [0.0], [0.0]   # an empty reference list scores 0
        for ref in references[cid]:
            rt = ref if pre_tokenized else ptb_tokenize(ref)
            lcs = _lcs_len(ct, rt)
            precs.append(lcs / max(len(ct), 1))
            recs.append(lcs / max(len(rt), 1))
        p, r = max(precs), max(recs)
        if p == 0 or r == 0:
            scores.append(0.0)
        else:
            scores.append((1 + beta ** 2) * p * r / (r + beta ** 2 * p))
    return sum(scores) / max(len(scores), 1)


# -------------------------------------------------------------- METEOR


def _align(hyp: Sequence[str], ref: Sequence[str]) -> List[Tuple[int, int]]:
    """Exact matches first (each hypothesis token, in order, to the
    leftmost unused reference position), then Porter-stem matches over the
    rest → sorted (hyp index, ref index) pairs."""
    pairs: List[Tuple[int, int]] = []
    used_h = [False] * len(hyp)
    used_r = [False] * len(ref)
    for key_h, key_r in (
        (list(hyp), list(ref)),
        ([_porter.stem(t) for t in hyp], [_porter.stem(t) for t in ref]),
    ):
        for i, h in enumerate(key_h):
            if used_h[i]:
                continue
            for j, r in enumerate(key_r):
                if not used_r[j] and h == r:
                    pairs.append((i, j))
                    used_h[i] = used_r[j] = True
                    break
    return sorted(pairs)


# (alpha, beta, gamma): F_alpha-mean and the penalty gamma·(chunks/m)^beta;
# "2005" Banerjee & Lavie 2005, "1.5en" METEOR-1.5's English constants
# (the Java jar's family, without its synonym and paraphrase stages)
METEOR_PARAMS = {
    "2005": (0.9, 3.0, 0.5),
    "1.5en": (0.85, 0.2, 0.6),
}


def _meteor_sentence(hyp: Sequence[str], ref: Sequence[str],
                     params: str = "2005") -> float:
    alpha, beta, gamma = METEOR_PARAMS[params]
    pairs = _align(hyp, ref)
    m = len(pairs)
    if m == 0 or not hyp or not ref:
        return 0.0
    p = m / len(hyp)
    r = m / len(ref)
    f_mean = p * r / (alpha * p + (1.0 - alpha) * r)
    # chunks: maximal runs where both indices advance by one
    chunks = 1
    for (h0, r0), (h1, r1) in zip(pairs, pairs[1:]):
        if h1 != h0 + 1 or r1 != r0 + 1:
            chunks += 1
    return f_mean * (1.0 - gamma * (chunks / m) ** beta)


def meteor(candidates: Dict, references: Dict,
           pre_tokenized: bool = False, params: str = "2005") -> float:
    """Mean over images of the best sentence METEOR over the
    references."""
    scores = []
    for cid, cand in candidates.items():
        hyp = cand if pre_tokenized else ptb_tokenize(cand)
        best = 0.0
        for ref in references[cid]:
            rt = ref if pre_tokenized else ptb_tokenize(ref)
            best = max(best, _meteor_sentence(hyp, rt, params=params))
        scores.append(best)
    return sum(scores) / max(len(scores), 1)


def coco_caption_eval(results: List[dict], gts: Dict[object, List[str]]
                      ) -> Dict[str, float]:
    """results [{image_id, caption}], gts {image_id: [refs]} → Bleu_1..4,
    METEOR ("1.5en"), ROUGE_L, CIDEr (each rounded to 4 places), SPICE
    None and ``agg_metrics`` = CIDEr + BLEU-4 rounded to 4 places.  Only
    results whose image has references are scored."""
    cands = {r["image_id"]: ptb_tokenize(r["caption"]) for r in results
             if r["image_id"] in gts}
    refs = {cid: [ptb_tokenize(t) for t in gts[cid]] for cid in cands}
    bleu = corpus_bleu(cands, refs, pre_tokenized=True)
    cd = cider_d(cands, refs, pre_tokenized=True)
    out = {f"Bleu_{i + 1}": round(b, 4) for i, b in enumerate(bleu)}
    out["METEOR"] = round(meteor(cands, refs, pre_tokenized=True,
                                 params="1.5en"), 4)
    out["ROUGE_L"] = round(rouge_l(cands, refs, pre_tokenized=True), 4)
    out["CIDEr"] = round(cd, 4)
    out["SPICE"] = None
    out["agg_metrics"] = round(cd + bleu[3], 4)
    return out
