"""The port's captioning path vs nltk 3.10 and the JAX package on the CPU:

- ``evaluation/_treebank.py`` against nltk's ``TreebankWordTokenizer``
  (``convert_parentheses=True``) on a fixed corpus that covers every rule
  group, and on the 50-caption corpus of
  ``tests/test_caption_metrics_golden.py``: token lists equal;
- ``evaluation/_porter.py`` against nltk's ``PorterStemmer()`` on a fixed
  word list of a few hundred words that reaches every step of the
  algorithm and the irregular-form pool: stems equal;
- each scorer of ``evaluation/caption_metrics.py`` and
  ``coco_caption_eval`` against the JAX module (which tokenizes and stems
  with nltk) on that corpus and on seeded random captions: within 1e-12,
  and the rounded dict equal;
- ``CaptionTask`` on the tiny fp32 InstructBLIP-T5 (weights carried by the
  bridge) against the JAX task, beams 1 and 2 with a ``min_len`` that
  binds: captions, metrics, the result file and the ``evaluate.txt`` line
  equal; a Vicuna model raises; ``setup_task`` reads the NoCaps and COCO
  eval yamls as the JAX task does.
"""

import random
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from nltk.stem import PorterStemmer
from nltk.tokenize import TreebankWordTokenizer

from test_caption_metrics_golden import _synth_corpus
from test_torch_models import tiny_blip, tiny_blip_configs
from vlm_compression_tpu.common.registry import registry as jax_registry
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.datasets import tokenization as JTok
from vlm_compression_tpu.evaluation import caption_metrics as JM
from vlm_compression_tpu.tasks import captioning as JC
from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.evaluation import _porter, _treebank
from vlm_compression_tpu_torch.evaluation import caption_metrics as TM
from vlm_compression_tpu_torch.models import blip2_t5_instruct as TB
from vlm_compression_tpu_torch.models import blip2_vicuna_instruct as TBV
from vlm_compression_tpu_torch.models.bridge import load_jax_variables
from vlm_compression_tpu_torch.tasks import captioning as TC

ROOT = Path(__file__).resolve().parents[1]

# ---------------------------------------------------------------- Treebank

# one group of sentences per rule group of the tokenizer
TREEBANK_CORPUS = {
    "starting_quotes": [
        '"Hello," she said.', "''Double single'' quotes", 'a ("quoted") b',
        '[''inner''] {"x"} <"y">', '"', "``already open'' he said",
    ],
    "punctuation": [
        "a:b, c: d", "3,000 cars at 4:30", "end,", "trailing:",
        "Wait... what?", "a;b@c#d$e%f&g", "He left.", "(Done.)",
        "'Quote.'", 'He said "stop."', "Really?!", "dogs' bones here",
        "The U.S. team won.", "3.14 is pi.", "a b. c d.", "ok .",
    ],
    "parens_brackets": [
        "(a) [b] {c} <d>", "f(x)=[y]", "nested ((deep)) {[mixed]}",
        "<html> tags </html>",
    ],
    "double_dashes": [
        "well--maybe", "a -- b", "one---two", "-- leading and trailing --",
        "a well-lit room - with (two) windows, yes.",
    ],
    "ending_quotes": [
        'he said "no"', "it's his dog's bone", "I'm sure he'd go",
        "you'll see they're here and we've won", "don't DON'T can't won't",
        "I'LL SHE'S THEY'RE WE'VE HE'D I'M", "the boys' 'quoted' words",
        "rock 'n' roll", "''", "a ''b'' c",
    ],
    "contractions": [
        "cannot", "Cannot", "d'ye", "gimme", "gonna", "Gotta", "lemme",
        "more'n", "I wanna go", "wanna", "'tis", "'Twas the night",
        "it 'tis", "gonna wanna gotta gimme lemme", "whaddya whatcha",
    ],
    "whitespace_and_unicode": [
        "tabs\tand\nnew\rlines", "  leading and trailing  ", "",
        "café naïve résumé", "emoji 🙂 here!", "ÉCOLE's",
    ],
}


def _treebank_cases():
    for group, sentences in TREEBANK_CORPUS.items():
        for i, s in enumerate(sentences):
            yield pytest.param(s, id=f"{group}_{i}")


@pytest.mark.parametrize("sentence", list(_treebank_cases()))
def test_treebank_copy_matches_nltk(sentence):
    want = TreebankWordTokenizer().tokenize(sentence,
                                            convert_parentheses=True)
    assert _treebank.tokenize(sentence) == want


def test_treebank_copy_matches_nltk_on_the_golden_corpus():
    cands, refs = _synth_corpus()
    texts = list(cands.values()) + [r for rs in refs.values() for r in rs]
    nltk_tb = TreebankWordTokenizer()
    assert len(texts) > 100
    for s in texts:
        assert _treebank.tokenize(s) == \
            nltk_tb.tokenize(s, convert_parentheses=True), s

# ------------------------------------------------------------------ Porter

# the paper's examples of each step, nltk's extensions and its pool
PORTER_EXAMPLES = {
    "step1a": ["caresses", "ponies", "ties", "caress", "cats", "flies",
               "dies", "lies", "pies", "s", "ss", "is", "gas", "this"],
    "step1b": ["feed", "agreed", "plastered", "bled", "motoring", "sing",
               "conflated", "troubled", "sized", "hopping", "tanned",
               "falling", "hissing", "fizzed", "failing", "filing",
               "spied", "died", "tied", "bleed", "speed", "need", "hoped",
               "hopped", "rated", "rating", "matting", "mating", "meeting",
               "milling", "messing", "meetings", "exceeding", "ed", "ing",
               "sled", "red", "bring", "string"],
    "step1c": ["happy", "sky", "enjoy", "spy", "fly", "try", "by", "y",
               "cry", "employ", "toy", "syzygy", "yyyy", "ayyy"],
    "step2": ["relational", "conditional", "rational", "valenci",
              "hesitanci", "digitizer", "conformabli", "radicalli",
              "differentli", "vileli", "analogousli", "vietnamization",
              "predication", "operator", "feudalism", "decisiveness",
              "hopefulness", "callousness", "formaliti", "sensitiviti",
              "sensibiliti", "generalli", "hopefulli", "analogi",
              "geologi", "theologi", "archaeologi", "philologi", "apologi",
              "bli", "abli", "fulli", "tional"],
    "step3": ["triplicate", "formative", "formalize", "electriciti",
              "electrical", "hopeful", "goodness", "duplicate",
              "ative", "careful", "kindness", "practical"],
    "step4": ["revival", "allowance", "inference", "airliner",
              "gyroscopic", "adjustable", "defensible", "irritant",
              "replacement", "adjustment", "dependent", "adoption",
              "homologou", "communism", "activate", "angulariti",
              "homologous", "effective", "bowdlerize", "nation", "lion",
              "opinion", "ion", "emotion", "decision", "element",
              "cement", "tent", "ant"],
    "step5": ["probate", "rate", "cease", "controll", "roll", "toll",
              "generalize", "revive", "eye", "one", "little", "little",
              "tell", "spelling", "fallen"],
    "pool": ["sky", "skies", "dying", "lying", "tying", "news", "innings",
             "inning", "outings", "outing", "cannings", "canning", "howe",
             "proceed", "exceed", "succeed", "Skies", "NEWS"],
    "case_and_short": ["Running", "CATS", "A", "Is", "OX", "at", "Be",
                       "HAPPINESS", "Generalizations", "I"],
}
STEMS = ["connect", "relat", "form", "hope", "run", "operat", "general",
         "sens", "elect", "adjust", "nation", "commun", "activ", "effect",
         "control", "decis", "happ", "digit", "valu", "condit", "organ",
         "rational", "ceas", "fil", "troubl", "rat", "feud", "predic"]
SUFFIXES = ["", "s", "es", "ed", "ing", "ings", "ly", "ness", "ful",
            "fulness", "ive", "iveness", "ation", "ational", "ization",
            "izer", "ism", "ist", "ity", "ities", "ment", "ments", "al",
            "ally", "ance", "ence", "able", "ible", "ant", "ent", "ous",
            "ously", "ize", "izes", "ate", "ates", "er", "ers", "ic",
            "ical", "icity"]


def test_porter_word_list_reaches_every_step():
    words = [w for ws in PORTER_EXAMPLES.values() for w in ws]
    words += [s + x for s in STEMS for x in SUFFIXES]
    assert len(set(words)) > 1000
    # every step changes some word of the list
    steps = (_porter._step1a, _porter._step1b, _porter._step1c,
             _porter._step2, _porter._step3, _porter._step4,
             _porter._step5a, _porter._step5b)
    for step in steps:
        assert any(step(w.lower()) != w.lower() for w in words), step


@pytest.mark.parametrize("group", list(PORTER_EXAMPLES) + ["generated"])
def test_porter_copy_matches_nltk(group):
    words = PORTER_EXAMPLES.get(group) or [s + x for s in STEMS
                                           for x in SUFFIXES]
    nltk_stemmer = PorterStemmer()
    for w in words:
        assert _porter.stem(w) == nltk_stemmer.stem(w), w


def test_porter_pool_is_nltks():
    assert _porter.POOL == PorterStemmer().pool

# ----------------------------------------------------------------- scorers


def _random_corpus(seed, n=40):
    """Seeded captions over a small vocabulary with punctuation, brackets,
    contractions and inflected words; 1-5 references an image, some of
    them empty."""
    rng = random.Random(seed)
    vocab = ["a", "the", "dog", "dogs", "running", "runs", "ran", "man's",
             "men", "isn't", "(two)", "[red]", "bikes,", "riding.",
             "happily", "happiness", "quickly--", '"quoted"', "can't",
             "gonna", "near", "on", "grassy", "fields", "field", "cat",
             "sitting", "sits", "generalization", "it's", "...", "?"]

    def sentence():
        return " ".join(rng.choice(vocab) for _ in range(rng.randint(0, 12)))

    cands = {i: sentence() for i in range(n)}
    refs = {i: [sentence() for _ in range(rng.randint(1, 5))]
            for i in range(n)}
    return cands, refs


CORPORA = {"golden": _synth_corpus(), "random0": _random_corpus(0),
           "random1": _random_corpus(1), "random2": _random_corpus(2)}


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_ptb_tokenize_matches_jax(corpus):
    cands, refs = CORPORA[corpus]
    for s in list(cands.values()) + [r for rs in refs.values() for r in rs]:
        assert TM.ptb_tokenize(s) == JM.ptb_tokenize(s), s


SCORERS = {"bleu": ("corpus_bleu", {}), "cider_d": ("cider_d", {}),
           "rouge_l": ("rouge_l", {}),
           "meteor_2005": ("meteor", {"params": "2005"}),
           "meteor_1.5en": ("meteor", {"params": "1.5en"})}


@pytest.mark.parametrize("scorer", list(SCORERS))
@pytest.mark.parametrize("corpus", list(CORPORA))
def test_caption_scorers_match_jax(corpus, scorer):
    cands, refs = CORPORA[corpus]
    name, kw = SCORERS[scorer]
    got = getattr(TM, name)(cands, refs, **kw)
    want = getattr(JM, name)(cands, refs, **kw)
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("corpus", list(CORPORA))
def test_coco_caption_eval_matches_jax(corpus):
    cands, refs = CORPORA[corpus]
    results = [{"image_id": k, "caption": v} for k, v in cands.items()]
    # a result without references is left out of the scores
    results.append({"image_id": "no_refs", "caption": "a dog"})
    got, want = TM.coco_caption_eval(results, refs), \
        JM.coco_caption_eval(results, refs)
    assert got == want
    assert got["SPICE"] is None
    assert got["agg_metrics"] == round(
        TM.cider_d(cands, refs) + TM.corpus_bleu(cands, refs)[3], 4)


def test_identical_captions_score_one():
    """The chip run's closed form: each image's references set to its own
    caption give BLEU-1..4 and ROUGE-L of exactly 1."""
    cands, _ = _random_corpus(3)
    cands = {k: v + " dog" for k, v in cands.items()}
    m = TM.coco_caption_eval(
        [{"image_id": k, "caption": v} for k, v in cands.items()],
        {k: [v] for k, v in cands.items()})
    for key in ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "ROUGE_L"):
        assert m[key] == 1.0, (key, m)
    assert m == JM.coco_caption_eval(
        [{"image_id": k, "caption": v} for k, v in cands.items()],
        {k: [v] for k, v in cands.items()})

# -------------------------------------------------------------------- task


# the tiny model's EOS logit made 1.05 times that of a token it often
# emits, so that its captions end early and ``min_len`` binds
EOS, OFTEN = 1, 59


@pytest.fixture(scope="module")
def tiny():
    jm, variables, _, _ = tiny_blip(seed=41, masks=True)
    for coll, leaf in (("params", "kernel"), ("masks", "mask")):
        node = variables[coll]["t5_model"]["lm_head"]
        node[leaf] = np.array(node[leaf])
        node[leaf][:, EOS] = node[leaf][:, OFTEN] * (
            1.05 if leaf == "kernel" else True)
    tm = TB.Blip2T5Instruct(tiny_blip_configs()[1], device="cpu")
    load_jax_variables(tm, variables)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm


def _tasks(tiny, **kw):
    jm, variables, tm = tiny
    toks = {}
    for side, mod in (("jax", JTok), ("torch", TTok)):
        toks[side] = dict(
            tokenizer=mod.SimpleTokenizer(jm.cfg.t5.vocab_size),
            qformer_tokenizer=mod.SimpleTokenizer(jm.cfg.qformer.vocab_size))
    return ((JC.CaptionTask(**kw, **toks["jax"]), FlaxModel(jm, variables)),
            (TC.CaptionTask(**kw, **toks["torch"]), tm))


def _samples(tiny, seed, b=4):
    jm, _, _ = tiny
    rng = np.random.default_rng(seed)
    img = jm.cfg.vit.img_size
    return {"image": rng.standard_normal((b, img, img, 3)).astype(np.float32),
            "image_id": [f"img{i}" for i in range(b)]}


def _n_tokens(caption):
    return len(caption.split())


@pytest.mark.parametrize("beams", [1, 2])
def test_caption_task_matches_jax(tiny, tmp_path, beams):
    samples = _samples(tiny, 42 + beams)
    # min_length counts the start token: EOS comes no earlier than
    # position min_len, after at least min_len - 1 caption tokens.
    # Without it some caption ends earlier, so it binds
    min_len = 6
    (_, _), (free, tm) = _tasks(tiny, num_beams=beams, max_len=8, min_len=1,
                                prompt="a photo of")
    with torch.no_grad():
        short = free.evaluation(tm, [samples])
    assert any(_n_tokens(r["caption"]) < min_len - 1 for r in short), short
    (jt, jmodel), (tt, tm) = _tasks(tiny, num_beams=beams, max_len=8,
                                    min_len=min_len, prompt="a photo of")
    want = jt.evaluation(jmodel, [samples])
    with torch.no_grad():
        got = tt.evaluation(tm, [samples])
    assert got == want
    assert all(_n_tokens(r["caption"]) >= min_len - 1 for r in got), got
    # references: the image's own caption for the even images, another
    # caption and a sentence for the odd ones
    gts = {r["image_id"]: ([r["caption"]] if i % 2 == 0 else
                           [got[i - 1]["caption"], "a dog on the grass"])
           for i, r in enumerate(got)}
    metrics = []
    for side, task, res in (("jax", jt, want), ("torch", tt, got)):
        task.gts = dict(gts)
        rd = tmp_path / side / "result"
        rd.mkdir(parents=True)
        metrics.append(task.after_evaluation(res, split_name="val",
                                             result_dir=str(rd)))
    assert metrics[0] == metrics[1]
    assert metrics[1]["SPICE"] is None and metrics[1]["Bleu_1"] > 0
    for name in ("result/val_caption_result.json", "evaluate.txt"):
        assert (tmp_path / "torch" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()


def test_caption_task_without_gts_reports_zero(tiny, tmp_path):
    (jt, _), (tt, _) = _tasks(tiny)
    res = [{"image_id": 1, "caption": "<5> <6>"}]
    assert tt.after_evaluation(res, result_dir=str(tmp_path / "r")) == \
        jt.after_evaluation(res, result_dir=str(tmp_path / "j")) == \
        {"agg_metrics": 0.0}


def test_before_evaluation_collects_gts_as_jax_does(tiny):
    ds = types.SimpleNamespace(annotation=[
        {"image_id": 1, "caption": "a dog"},
        {"image_id": 1, "caption": ["a brown dog", "dog on grass"]},
        {"instance_id": "x", "caption": "a cat"},
        {"image_id": 2}])
    other = types.SimpleNamespace(annotation=[{"image_id": 3,
                                               "caption": "a car"}])
    for dataset in (ds, {"nocaps": {"val": ds, "test": other},
                         "ignored": []}):
        (jt, _), (tt, tm) = _tasks(tiny)
        jt.before_evaluation(None, dataset)
        tt.before_evaluation(tm, dataset)
        assert tt.gts == jt.gts and tt.gts


def test_caption_task_refuses_vicuna():
    model = TBV.Blip2VicunaInstruct(TBV.Blip2VicunaInstructConfig.tiny(),
                                    device="cpu")
    task = TC.CaptionTask(tokenizer=TTok.SimpleTokenizer(96))
    with pytest.raises(NotImplementedError, match="InstructBLIP-T5"):
        task.valid_step(model, {"image": np.zeros((1, 28, 28, 3),
                                                  np.float32),
                                "image_id": [0]})


@pytest.mark.parametrize("name", ["nocaps", "caption_coco"])
def test_setup_task_reads_the_caption_yaml_as_jax_does(name):
    path = (ROOT / "configs" / "projects" / "eval"
            / f"{name}_flant5xl_instruct_eval.yaml")
    cfg = yaml.safe_load(path.read_text())
    task_name = cfg["run"]["task"]
    jcls = jax_registry.get_task_class(task_name)
    tcls = registry.get_task_class(task_name)
    assert task_name == "captioning" and tcls is TC.CaptionTask
    assert tcls.__name__ == jcls.__name__
    jt = jcls.setup_task(types.SimpleNamespace(run_cfg=cfg["run"],
                                               model_cfg=cfg["model"]))
    tt = tcls.setup_task(cfg, tokenizer=TTok.SimpleTokenizer())
    for attr in ("num_beams", "max_len", "min_len", "prompt"):
        assert getattr(tt, attr) == getattr(jt, attr), attr
    assert (tt.num_beams, tt.max_len, tt.min_len, tt.prompt) == \
        (5, 30, 8, "a photo of")
    # with no tokenizer, both fall back to the offline SimpleTokenizer
    plain = tcls.setup_task(cfg)
    assert isinstance(plain.tokenizer, TTok.SimpleTokenizer)
    assert type(plain.tokenizer).__name__ == type(jt.tokenizer).__name__
