"""Answer lemmatization for OK-VQA-style evals (port of
``vlm_compression_tpu/evaluation/lemmatize.py``).

Each answer token whose POS is NOUN or VERB is replaced by its lemma, as
the reference does with spaCy ("skiing" → "ski", "dogs" → "dog").  spaCy
is probed as the JAX package probes it: where spaCy and
``en_core_web_sm`` load, both packages use them; elsewhere both apply the
same rule-based path — an irregular-form table plus orthographic suffix
rules (plural stripping, ``-ing`` / ``-ed`` with consonant undoubling and
silent-e restoration) on every token outside a function-word keep list.
"""

from __future__ import annotations

from typing import Iterable, List

_SPACY = None          # False = probed and unavailable
_VOWELS = set("aeiou")

# tokens never rewritten (function words + common false-positive stems)
_KEEP = frozenset("""
a an the and or but of in on at to is are was were be been being has have
had do does did his hers its ours yours theirs this us yes as gas bus plus
lens news species series pants jeans shorts scissors
always perhaps during less unless
""".split())

_IRREGULAR = {
    # nouns
    "men": "man", "women": "woman", "children": "child", "people": "person",
    "feet": "foot", "teeth": "tooth", "mice": "mouse", "geese": "goose",
    "knives": "knife", "wives": "wife", "lives": "life", "leaves": "leaf",
    "loaves": "loaf", "shelves": "shelf", "wolves": "wolf",
    "scarves": "scarf", "halves": "half", "sheep": "sheep", "fish": "fish",
    "glasses": "glass", "dishes": "dish", "buses": "bus", "oxen": "ox",
    # verbs
    "ran": "run", "running": "run", "ate": "eat", "eaten": "eat",
    "went": "go", "gone": "go", "going": "go", "flew": "fly",
    "flying": "fly", "flown": "fly", "swam": "swim", "swimming": "swim",
    "sat": "sit", "sitting": "sit", "stood": "stand", "standing": "stand",
    "held": "hold", "holding": "hold", "rode": "ride", "riding": "ride",
    "ridden": "ride", "drove": "drive", "driving": "drive",
    "driven": "drive", "threw": "throw", "throwing": "throw",
    "thrown": "throw", "caught": "catch", "catching": "catch",
    "slept": "sleep", "sleeping": "sleep", "lying": "lie", "lay": "lie",
    "made": "make", "making": "make", "took": "take", "taking": "take",
    "taken": "take", "gave": "give", "giving": "give", "given": "give",
    "wrote": "write", "writing": "write", "written": "write",
    "skiing": "ski", "surfing": "surf", "said": "say", "saying": "say",
    "seen": "see", "saw": "see", "worn": "wear", "wearing": "wear",
    "wore": "wear", "left": "leave", "leaving": "leave",
}


def _needs_e(stem: str) -> bool:
    """CVC heuristic: 'rid'→'ride', 'mak'→'make'; guards 'eat', 'walk'."""
    if len(stem) >= 3:
        c1, v, c2 = stem[-3], stem[-2], stem[-1]
        return (c2 not in _VOWELS and c2 not in "wxy"
                and v in _VOWELS
                and c1 not in _VOWELS)
    if len(stem) == 2:   # 'us' → 'use'
        return stem[-1] not in _VOWELS and stem[-2] in _VOWELS
    return False


def _de_inflect(stem: str) -> str:
    """Post-suffix cleanup shared by -ing/-ed: undouble, restore e."""
    if (len(stem) >= 3 and stem[-1] == stem[-2]
            and stem[-1] not in _VOWELS and stem[-1] not in "ls"):
        return stem[:-1]                       # stopp → stop
    if _needs_e(stem):
        return stem + "e"                      # rid → ride
    return stem


def _lemma_token(tok: str) -> str:
    low = tok.lower()
    if not low.isalpha() or low in _KEEP:
        return tok
    if low in _IRREGULAR:
        return _IRREGULAR[low]
    n = len(low)
    # ---- plural nouns / 3rd-person verbs ----
    if low.endswith("ies") and n > 4:
        return low[:-3] + "y"                  # berries → berry
    for suf in ("sses", "shes", "ches", "xes", "zes"):
        if low.endswith(suf) and n > len(suf):
            return low[:-2]                    # dishes → dish
    if low.endswith("oes") and n > 4:
        return low[:-2]                        # potatoes → potato
    if (low.endswith("s") and not low.endswith("ss")
            and not low.endswith("us") and not low.endswith("is")
            and n > 3):
        return low[:-1]                        # dogs → dog
    # ---- progressive / past ----
    if low.endswith("ing") and n >= 6:
        return _de_inflect(low[:-3])           # smiling → smile
    if low.endswith("ed") and n >= 5:
        return _de_inflect(low[:-2])           # baked → bake
    return low


def _rule_lemmatize_one(answer: str) -> str:
    return " ".join(_lemma_token(t) for t in answer.split())


def _get_spacy():
    global _SPACY
    if _SPACY is None:
        try:
            import spacy

            _SPACY = spacy.load("en_core_web_sm")
        except Exception:
            _SPACY = False
    return _SPACY


def lemmatize(answers: Iterable[str]) -> List[str]:
    """Lemma for NOUN/VERB tokens, text for the rest, space-joined."""
    nlp = _get_spacy()
    if nlp:
        out = []
        for answer in answers:
            words = [t.lemma_ if t.pos_ in ("NOUN", "VERB") else t.text
                     for t in nlp(answer)]
            out.append(" ".join(words))
        return out
    return [_rule_lemmatize_one(a) for a in answers]
