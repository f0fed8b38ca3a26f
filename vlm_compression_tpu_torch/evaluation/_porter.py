# Copied from NLTK 3.10.0, nltk/stem/porter.py.
#
# Natural Language Toolkit: Porter Stemmer
# Copyright (C) 2001-2026 NLTK Project
# URL: <https://www.nltk.org>
#
# Licensed under the Apache License, Version 2.0 (the "License"); you may
# not use this file except in compliance with the License.  You may obtain
# a copy of the License at http://www.apache.org/licenses/LICENSE-2.0
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.
#
# Changes: only the default NLTK_EXTENSIONS mode is kept (the
# ORIGINAL_ALGORITHM and MARTIN_EXTENSIONS branches are dropped), and
# ``stem`` always lowercases; the rules, their order and conditions are
# nltk's.
"""The Porter stemmer (nltk's ``PorterStemmer()``, NLTK_EXTENSIONS mode),
host only: the METEOR stem matcher, without nltk, which the card's machine
does not have.

Porter, M. "An algorithm for suffix stripping." Program 14.3 (1980):
130-137, with the extensions of Martin Porter's own implementations and
of nltk's contributors.
"""

from __future__ import annotations

# irregular forms, stemmed by lookup before the rules
_IRREGULAR = {
    "sky": ["sky", "skies"],
    "die": ["dying"],
    "lie": ["lying"],
    "tie": ["tying"],
    "news": ["news"],
    "inning": ["innings", "inning"],
    "outing": ["outings", "outing"],
    "canning": ["cannings", "canning"],
    "howe": ["howe"],
    "proceed": ["proceed"],
    "exceed": ["exceed"],
    "succeed": ["succeed"],
}
POOL = {form: key for key, forms in _IRREGULAR.items() for form in forms}
VOWELS = frozenset("aeiou")


def _is_consonant(word: str, i: int) -> bool:
    """A letter other than a vowel, and other than a y that follows a
    consonant (a run of y's resolved without recursion)."""
    if word[i] in VOWELS:
        return False
    if word[i] == "y":
        negate = False
        while i > 0 and word[i] == "y":
            negate = not negate
            i -= 1
        return (word[i] not in VOWELS) != negate
    return True


def _measure(stem: str) -> int:
    """m of [C](VC){m}[V]: the number of vowel-consonant boundaries."""
    cv = "".join("c" if _is_consonant(stem, i) else "v"
                 for i in range(len(stem)))
    return cv.count("vc")


def _has_positive_measure(stem: str) -> bool:
    return _measure(stem) > 0


def _contains_vowel(stem: str) -> bool:
    return any(not _is_consonant(stem, i) for i in range(len(stem)))


def _ends_double_consonant(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and _is_consonant(word, len(word) - 1))


def _ends_cvc(word: str) -> bool:
    """*o: the stem ends consonant-vowel-consonant, the last not w, x or
    y; or (nltk's extension) it is a vowel then a consonant."""
    return (len(word) >= 3
            and _is_consonant(word, len(word) - 3)
            and not _is_consonant(word, len(word) - 2)
            and _is_consonant(word, len(word) - 1)
            and word[-1] not in ("w", "x", "y")) or (
        len(word) == 2
        and not _is_consonant(word, 0)
        and _is_consonant(word, 1))


def _replace_suffix(word: str, suffix: str, replacement: str) -> str:
    if suffix == "":
        return word + replacement
    return word[: -len(suffix)] + replacement


def _apply_rule_list(word: str, rules) -> str:
    """The first rule whose suffix matches decides: its replacement if its
    condition holds (or it has none), else the word unchanged."""
    for suffix, replacement, condition in rules:
        if suffix == "*d" and _ends_double_consonant(word):
            stem = word[:-2]
            if condition is None or condition(stem):
                return stem + replacement
            return word
        if word.endswith(suffix):
            stem = _replace_suffix(word, suffix, "")
            if condition is None or condition(stem):
                return stem + replacement
            return word
    return word


def _step1a(word: str) -> str:
    if word.endswith("ies") and len(word) == 4:
        return _replace_suffix(word, "ies", "ie")
    return _apply_rule_list(word, [
        ("sses", "ss", None),
        ("ies", "i", None),
        ("ss", "ss", None),
        ("s", "", None),
    ])


def _step1b(word: str) -> str:
    if word.endswith("ied"):
        if len(word) == 4:
            return _replace_suffix(word, "ied", "ie")
        return _replace_suffix(word, "ied", "i")
    if word.endswith("eed"):
        stem = _replace_suffix(word, "eed", "")
        if _measure(stem) > 0:
            return stem + "ee"
        return word
    rule_2_or_3_succeeded = False
    for suffix in ("ed", "ing"):
        if word.endswith(suffix):
            intermediate_stem = _replace_suffix(word, suffix, "")
            if _contains_vowel(intermediate_stem):
                rule_2_or_3_succeeded = True
                break
    if not rule_2_or_3_succeeded:
        return word
    return _apply_rule_list(intermediate_stem, [
        ("at", "ate", None),
        ("bl", "ble", None),
        ("iz", "ize", None),
        ("*d", intermediate_stem[-1],
         lambda stem: intermediate_stem[-1] not in ("l", "s", "z")),
        ("", "e", lambda stem: _measure(stem) == 1 and _ends_cvc(stem)),
    ])


def _step1c(word: str) -> str:
    # y → i only after a consonant that is not the stem's only letter
    return _apply_rule_list(word, [
        ("y", "i",
         lambda stem: len(stem) > 1 and _is_consonant(stem, len(stem) - 1)),
    ])


def _step2(word: str) -> str:
    # nltk applies ALLI → AL first and, if it succeeds, step 2 again
    if word.endswith("alli") and _has_positive_measure(
            _replace_suffix(word, "alli", "")):
        return _step2(_replace_suffix(word, "alli", "al"))
    pos = _has_positive_measure
    rules = [
        ("ational", "ate", pos),
        ("tional", "tion", pos),
        ("enci", "ence", pos),
        ("anci", "ance", pos),
        ("izer", "ize", pos),
        ("bli", "ble", pos),
        ("alli", "al", pos),
        ("entli", "ent", pos),
        ("eli", "e", pos),
        ("ousli", "ous", pos),
        ("ization", "ize", pos),
        ("ation", "ate", pos),
        ("ator", "ate", pos),
        ("alism", "al", pos),
        ("iveness", "ive", pos),
        ("fulness", "ful", pos),
        ("ousness", "ous", pos),
        ("aliti", "al", pos),
        ("iviti", "ive", pos),
        ("biliti", "ble", pos),
        ("fulli", "ful", pos),
        # the l of logi stays with the stem
        ("logi", "log", lambda stem: _has_positive_measure(word[:-3])),
    ]
    return _apply_rule_list(word, rules)


def _step3(word: str) -> str:
    pos = _has_positive_measure
    return _apply_rule_list(word, [
        ("icate", "ic", pos),
        ("ative", "", pos),
        ("alize", "al", pos),
        ("iciti", "ic", pos),
        ("ical", "ic", pos),
        ("ful", "", pos),
        ("ness", "", pos),
    ])


def _step4(word: str) -> str:
    def gt1(stem):
        return _measure(stem) > 1

    return _apply_rule_list(word, [
        ("al", "", gt1),
        ("ance", "", gt1),
        ("ence", "", gt1),
        ("er", "", gt1),
        ("ic", "", gt1),
        ("able", "", gt1),
        ("ible", "", gt1),
        ("ant", "", gt1),
        ("ement", "", gt1),
        ("ment", "", gt1),
        ("ent", "", gt1),
        ("ion", "", lambda stem: _measure(stem) > 1 and stem[-1] in ("s", "t")),
        ("ou", "", gt1),
        ("ism", "", gt1),
        ("ate", "", gt1),
        ("iti", "", gt1),
        ("ous", "", gt1),
        ("ive", "", gt1),
        ("ize", "", gt1),
    ])


def _step5a(word: str) -> str:
    # both conditions are tried for the one suffix
    if word.endswith("e"):
        stem = _replace_suffix(word, "e", "")
        if _measure(stem) > 1:
            return stem
        if _measure(stem) == 1 and not _ends_cvc(stem):
            return stem
    return word


def _step5b(word: str) -> str:
    return _apply_rule_list(
        word, [("ll", "l", lambda stem: _measure(word[:-1]) > 1)])


def stem(word: str) -> str:
    """``PorterStemmer().stem(word)``: lowercased; the irregular forms by
    lookup; words of one or two letters unchanged."""
    s = word.lower()
    if s in POOL:
        return POOL[s]
    if len(word) <= 2:
        return s
    for step in (_step1a, _step1b, _step1c, _step2, _step3, _step4,
                 _step5a, _step5b):
        s = step(s)
    return s
