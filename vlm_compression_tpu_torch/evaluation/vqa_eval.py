"""Official VQA accuracy protocol (port of
``vlm_compression_tpu/evaluation/vqa_eval.py``), the rules of the official
VQAv2 evaluation:

  * answers lowercased; newlines and tabs become spaces;
  * punctuation stripped (kept inside digit groups for , and .);
  * number words become digits; articles (a/an/the) dropped;
  * contractions normalized (dont → don't, …);
  * accuracy per question = min(1, #annotators matching / 3), averaged
    over the leave-one-out subsets of the annotators.

GQA uses exact match after the same normalization.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're",
    "theres": "there's", "theyd": "they'd", "theyd've": "they'd've",
    "they'dve": "they'd've", "theyll": "they'll", "theyre": "they're",
    "theyve": "they've", "twas": "'twas", "wasnt": "wasn't",
    "wed've": "we'd've", "we'dve": "we'd've", "weve": "we've",
    "werent": "weren't", "whatll": "what'll", "whatre": "what're",
    "whats": "what's", "whatve": "what've", "whens": "when's",
    "whered": "where'd", "wheres": "where's", "whereve": "where've",
    "whod": "who'd", "whod've": "who'd've", "who'dve": "who'd've",
    "wholl": "who'll", "whos": "who's", "whove": "who've",
    "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

ARTICLES = {"a", "an", "the"}

PUNCT = [";", "/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
         "_", "-", ">", "<", "@", "`", ",", "?", "!"]

_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or (
                re.search(_COMMA_STRIP, text) is not None):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def process_digit_article(text: str) -> str:
    out = []
    for word in text.lower().split():
        word = NUMBER_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip().lower()
    return process_digit_article(process_punctuation(ans))


def vqa_accuracy(pred: str, gt_answers: Sequence[str]) -> float:
    """Leave-one-out averaged min(1, matches/3) — official protocol."""
    pred = normalize_answer(pred)
    gts = [normalize_answer(a) for a in gt_answers]
    if len(gts) <= 1:
        return float(pred == gts[0]) if gts else 0.0
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        matching = sum(1 for a in others if a == pred)
        accs.append(min(1.0, matching / 3.0))
    return sum(accs) / len(accs)


class VQAEval:
    """Aggregate accuracy over {question_id: (pred, gt_answers[, type])}."""

    def __init__(self, n: int = 2):
        self.n = n
        self.accuracy: Dict[str, float] = {}
        self.eval_qa: Dict = {}

    def evaluate(self, results: List[dict]) -> Dict[str, float]:
        """results: [{question_id, answer(pred), gt_answers,
        answer_type?(optional)}]"""
        per_q, by_type = {}, {}
        for r in results:
            acc = vqa_accuracy(r["answer"], r["gt_answers"])
            per_q[r["question_id"]] = acc
            t = r.get("answer_type")
            if t:
                by_type.setdefault(t, []).append(acc)
        overall = (100.0 * sum(per_q.values()) / len(per_q)) if per_q else 0.0
        self.accuracy = {"overall": round(overall, self.n)}
        for t, accs in by_type.items():
            self.accuracy[t] = round(100.0 * sum(accs) / len(accs), self.n)
        self.eval_qa = per_q
        return self.accuracy


def gqa_exact_match(results: List[dict]) -> float:
    """GQA: normalized exact match, in percent."""
    if not results:
        return 0.0
    hits = sum(
        1 for r in results
        if normalize_answer(r["answer"]) == normalize_answer(r["gt_answers"][0]
           if isinstance(r["gt_answers"], (list, tuple)) else r["gt_answers"]))
    return 100.0 * hits / len(results)
