# Copied from NLTK 3.10.0, nltk/tokenize/treebank.py and
# nltk/tokenize/destructive.py (MacIntyreContractions).
#
# Natural Language Toolkit: Tokenizers
# Copyright (C) 2001-2026 NLTK Project
# Author: Edward Loper <edloper@gmail.com>
#         Michael Heilman <mheilman@cmu.edu> (re-port from
#         http://www.cis.upenn.edu/~treebank/tokenizer.sed)
#         Tom Aarsen <> (modifications)
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
# Changes: only ``TreebankWordTokenizer.tokenize`` with
# ``convert_parentheses=True`` is kept, as the module function
# ``tokenize``; the regular expressions and their order are nltk's.
"""Penn Treebank word tokenization (nltk's ``TreebankWordTokenizer``),
host only: the caption metrics' PTB tokenizer, without nltk, which the
card's machine does not have."""

from __future__ import annotations

import re
from typing import List

STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]

PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # the final period
    (re.compile(r'([^\.])(\.)([\]\)}>"\']*)\s*$'), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]

PARENS_BRACKETS = (re.compile(r"[\]\[\(\)\{\}\<\>]"), r" \g<0> ")

CONVERT_PARENTHESES = [
    (re.compile(r"\("), "-LRB-"),
    (re.compile(r"\)"), "-RRB-"),
    (re.compile(r"\["), "-LSB-"),
    (re.compile(r"\]"), "-RSB-"),
    (re.compile(r"\{"), "-LCB-"),
    (re.compile(r"\}"), "-RCB-"),
]

DOUBLE_DASHES = (re.compile(r"--"), r" -- ")

ENDING_QUOTES = [
    (re.compile(r"''"), " '' "),
    (re.compile(r'"'), " '' "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

# Robert MacIntyre's contractions (CONTRACTIONS4 stays unused, as in nltk
# and the sed script)
CONTRACTIONS2 = [re.compile(p) for p in (
    r"(?i)\b(can)(?#X)(not)\b",
    r"(?i)\b(d)(?#X)('ye)\b",
    r"(?i)\b(gim)(?#X)(me)\b",
    r"(?i)\b(gon)(?#X)(na)\b",
    r"(?i)\b(got)(?#X)(ta)\b",
    r"(?i)\b(lem)(?#X)(me)\b",
    r"(?i)\b(more)(?#X)('n)\b",
    r"(?i)\b(wan)(?#X)(na)(?=\s)",
)]
CONTRACTIONS3 = [re.compile(p) for p in (
    r"(?i) ('t)(?#X)(is)\b",
    r"(?i) ('t)(?#X)(was)\b",
)]


def tokenize(text: str) -> List[str]:
    """``TreebankWordTokenizer().tokenize(text, convert_parentheses=True)``:
    brackets become their PTB names (``-LRB-`` …)."""
    for regexp, substitution in STARTING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp, substitution in PUNCTUATION:
        text = regexp.sub(substitution, text)
    regexp, substitution = PARENS_BRACKETS
    text = regexp.sub(substitution, text)
    for regexp, substitution in CONVERT_PARENTHESES:
        text = regexp.sub(substitution, text)
    regexp, substitution = DOUBLE_DASHES
    text = regexp.sub(substitution, text)
    text = " " + text + " "
    for regexp, substitution in ENDING_QUOTES:
        text = regexp.sub(substitution, text)
    for regexp in CONTRACTIONS2:
        text = regexp.sub(r" \1 \2 ", text)
    for regexp in CONTRACTIONS3:
        text = regexp.sub(r" \1 \2 ", text)
    return text.split()
