"""A reader for the YAML subset the repository's configs use.

The card's machine has no PyYAML, so the port reads its configs with this
module, on every host alike.  ``safe_load(text)`` gives what
``yaml.safe_load`` gives for documents made of

* block mappings and block sequences (a sequence may sit at its key's
  indentation, and an entry may open a mapping: ``- key: value``);
* flow sequences and flow mappings on one line (``[a, b]``, ``{k: v}``);
* plain, single-quoted and double-quoted scalars on one line;
* comments and blank lines.

Plain scalars (keys too) resolve as YAML 1.1's implicit resolvers do in
PyYAML's ``SafeLoader``: null, bool, float, int and timestamp, else str
(``1e-6`` stays a string: YAML 1.1 floats need a dot and a signed
exponent).  Anything outside the subset raises ``ValueError``: anchors,
aliases, tags, block scalars (``|``, ``>``), complex keys, directives,
more than one document, tabs in indentation, and scalars or flow
collections that continue on another line.

``safe_dump_flat(mapping)`` writes a flat mapping of scalars (the
sparsity allocation, the training statistics) as a block mapping that
``yaml.safe_load`` and ``safe_load`` read back equal, keys sorted as
``yaml.safe_dump`` sorts them.
"""

from __future__ import annotations

import datetime
import json
import re
from typing import Any, List, Mapping, Tuple

_SPACE = " \t"
_FLOW = ",[]{}"

# PyYAML's implicit resolvers (resolver.py), in its order of registration
_BOOL = re.compile(r'''^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$''', re.X)
_FLOAT = re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X)
_INT = re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X)
_MERGE = re.compile(r'^(?:<<)$')
_NULL = re.compile(r'''^(?: ~
                    |null|Null|NULL
                    | )$''', re.X)
_TIMESTAMP = re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''',
                        re.X)
_VALUE = re.compile(r'^(?:=)$')
# SafeConstructor.timestamp_regexp
_TIMESTAMP_PARTS = re.compile(
    r'''^(?P<year>[0-9][0-9][0-9][0-9])
                -(?P<month>[0-9][0-9]?)
                -(?P<day>[0-9][0-9]?)
                (?:(?:[Tt]|[ \t]+)
                (?P<hour>[0-9][0-9]?)
                :(?P<minute>[0-9][0-9])
                :(?P<second>[0-9][0-9])
                (?:\.(?P<fraction>[0-9]*))?
                (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                (?::(?P<tz_minute>[0-9][0-9]))?))?)?$''', re.X)
_BOOLS = {"yes": True, "no": False, "true": True, "false": False,
          "on": True, "off": False}
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value: str, cast):
    total, base = cast(0), 1
    for digit in reversed([cast(part) for part in value.split(":")]):
        total += digit * base
        base *= 60
    return total


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def _timestamp(value: str):
    v = _TIMESTAMP_PARTS.match(value).groupdict()
    year, month, day = int(v["year"]), int(v["month"]), int(v["day"])
    if not v["hour"]:
        return datetime.date(year, month, day)
    fraction = 0
    if v["fraction"]:
        fraction = int(v["fraction"][:6].ljust(6, "0"))
    tzinfo = None
    if v["tz_sign"]:
        delta = datetime.timedelta(hours=int(v["tz_hour"]),
                                   minutes=int(v["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
    elif v["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(v["hour"]),
                             int(v["minute"]), int(v["second"]), fraction,
                             tzinfo=tzinfo)


def resolve_plain(value: str) -> Any:
    """A plain scalar's value under YAML 1.1's implicit resolvers, as
    ``yaml.safe_load`` resolves it."""
    if _BOOL.match(value):
        return _BOOLS[value.lower()]
    if _FLOAT.match(value):
        return _float(value)
    if _INT.match(value):
        return _int(value)
    if _MERGE.match(value) or _VALUE.match(value):
        raise ValueError(f"the scalar {value!r} resolves to a tag the safe "
                         "loader cannot construct")
    if _NULL.match(value):
        return None
    if _TIMESTAMP.match(value):
        return _timestamp(value)
    return value


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


def _marker(body: str, mark: str) -> bool:
    return body.startswith(mark) and body[3:4] in ("", " ", "\t")


class _Reader:
    def __init__(self, text: str):
        self.lines: List[_Line] = []
        # one document: an optional '---' first (with at most an inline
        # node after it), an optional '...' last
        self.inline = None
        started = ended = False
        for no, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(" ")
            if body.startswith("\t") and body.strip():
                self.fail(no, "a tab in the indentation")
            if not body.strip() or body.startswith("#"):
                continue
            top = len(body) == len(raw)
            rest = body[3:].strip(" \t")
            comment = not rest or rest.startswith("#")
            if ended or self.inline is not None:
                self.fail(no, "content after the document")
            if top and _marker(body, "---"):
                if started or self.lines:
                    self.fail(no, "more than one document")
                started = True
                if not comment:
                    self.inline = _Line(no, 0, rest)
                continue
            if top and _marker(body, "..."):
                if not (comment and (started or self.lines)):
                    self.fail(no, "a document end outside the subset")
                ended = True
                continue
            if body.startswith("%"):
                self.fail(no, "directives are outside the subset")
            self.lines.append(_Line(no, len(raw) - len(body), body))

    @staticmethod
    def fail(no, why):
        raise ValueError(f"line {no}: {why}")

    # -- one line's nodes ------------------------------------------------
    def end_of_node(self, line, pos: int) -> None:
        """After a node: only spaces and an optional comment."""
        text = line.text
        j = pos
        while j < len(text) and text[j] in _SPACE:
            j += 1
        if j < len(text) and not (text[j] == "#" and j > pos):
            self.fail(line.no, f"unexpected {text[j:]!r}")

    def quoted(self, line, pos: int) -> Tuple[str, int]:
        text, q = line.text, line.text[pos]
        out, j = [], pos + 1
        while True:
            if j >= len(text):
                self.fail(line.no, "a quoted scalar that goes on past its "
                                   "line")
            c = text[j]
            if q == "'":
                if c == "'":
                    if text[j + 1:j + 2] == "'":
                        out.append("'")
                        j += 2
                        continue
                    return "".join(out), j + 1
                out.append(c)
                j += 1
                continue
            if c == '"':
                return "".join(out), j + 1
            if c == "\\":
                e = text[j + 1:j + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    j += 2
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    digits = text[j + 2:j + 2 + n]
                    if len(digits) != n or not all(
                            d in "0123456789abcdefABCDEF" for d in digits):
                        self.fail(line.no, f"a bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    j += 2 + n
                else:
                    self.fail(line.no, f"an escape outside the subset: "
                                       f"\\{e}")
                continue
            out.append(c)
            j += 1

    def plain(self, line, pos: int, flow: bool) -> Tuple[str, int]:
        """A plain scalar from ``pos``: words joined by their spaces, up to
        ': ', ' #', the end of the line (and in a flow, ``,?[]{}``)."""
        text = line.text
        c, nxt = text[pos], text[pos + 1:pos + 2]
        if c in "-?:,[]{}#&*!|>'\"%@`" and not (
                nxt not in ("", " ", "\t")
                and (c == "-" or (not flow and c in "?:"))):
            if c in "&*":
                self.fail(line.no, "anchors and aliases are outside the "
                                   "subset")
            if c == "!":
                self.fail(line.no, "tags are outside the subset")
            if c in "|>":
                self.fail(line.no, "block scalars are outside the subset")
            self.fail(line.no, f"no scalar can start at {text[pos:]!r}")
        end = j = pos
        while j < len(text):
            ch = text[j]
            if ch == ":" and (j + 1 == len(text) or text[j + 1] in " \t"
                              or (flow and text[j + 1] in _FLOW)):
                break
            if ch in " \t":
                k = j
                while k < len(text) and text[k] in " \t":
                    k += 1
                if k == len(text) or text[k] == "#":
                    break
                j = k
                continue
            if flow and ch in _FLOW + "?":
                break
            j += 1
            end = j
        return text[pos:end], end

    def scalar(self, line, pos: int, flow: bool):
        if line.text[pos] in "'\"":
            return self.quoted(line, pos)
        value, end = self.plain(line, pos, flow)
        return resolve_plain(value), end

    def skip(self, text: str, j: int) -> int:
        while j < len(text) and text[j] in _SPACE:
            j += 1
        return j

    def flow(self, line, pos: int) -> Tuple[Any, int]:
        """A flow sequence or mapping that opens at ``pos``."""
        text = line.text
        close = "]" if text[pos] == "[" else "}"
        out: Any = [] if close == "]" else {}
        j = self.skip(text, pos + 1)
        while True:
            if j >= len(text) or text[j] == "#":
                self.fail(line.no, "a flow collection that goes on past "
                                   "its line")
            if text[j] == close:
                return out, j + 1
            if text[j] in "[{":
                node, j = self.flow(line, j)
                if close == "}":
                    self.fail(line.no, "a collection as a flow key is "
                                       "outside the subset")
            else:
                node, j = self.scalar(line, j, flow=True)
            j = self.skip(text, j)
            if close == "]":
                if j < len(text) and text[j] == ":":
                    self.fail(line.no, "a single-pair mapping inside a flow "
                                       "sequence is outside the subset")
                out.append(node)
            else:
                value = None
                if j < len(text) and text[j] == ":":
                    j = self.skip(text, j + 1)
                    if j < len(text) and text[j] not in ",}":
                        value, j = self.node_inline(line, j, flow=True)
                        j = self.skip(text, j)
                out[node] = value
            if j < len(text) and text[j] == ",":
                j = self.skip(text, j + 1)
            elif not (j < len(text) and text[j] == close):
                self.fail(line.no, f"expected ',' or {close!r} at "
                                   f"{text[j:]!r}")

    def node_inline(self, line, pos: int, flow: bool = False):
        if line.text[pos] in "[{":
            return self.flow(line, pos)
        return self.scalar(line, pos, flow)

    def split_key(self, line) -> Tuple[Any, int]:
        """(key, position after ':') when the line opens a mapping entry,
        else (None, -1)."""
        text = line.text
        if text[0] == "?" and text[1:2] in ("", " ", "\t"):
            self.fail(line.no, "complex keys are outside the subset")
        try:
            if text[0] in "[{":
                return None, -1
            key, j = self.scalar(line, 0, flow=False)
        except ValueError:
            return None, -1
        j = self.skip(text, j)
        if j < len(text) and text[j] == ":" and (
                j + 1 == len(text) or text[j + 1] in _SPACE):
            return key, j + 1
        return None, -1

    # -- blocks ------------------------------------------------------------
    @staticmethod
    def is_entry(line) -> bool:
        return line.text[0] == "-" and line.text[1:2] in ("", " ", "\t")

    def node(self, i: int) -> Tuple[Any, int]:
        line = self.lines[i]
        if self.is_entry(line):
            return self.sequence(i, line.indent)
        if self.split_key(line)[1] >= 0:
            return self.mapping(i, line.indent)
        value, end = self.node_inline(line, 0)
        self.end_of_node(line, end)
        if i + 1 < len(self.lines) and \
                self.lines[i + 1].indent > line.indent:
            self.fail(self.lines[i + 1].no, "a scalar that goes on past its "
                                            "line")
        return value, i + 1

    def child(self, i: int, indent: int, seq_at_indent: bool):
        """The node below a key or an entry whose own line held nothing
        more: on the next line, more indented (or, below a key, a sequence
        at the key's indentation); else null."""
        if i < len(self.lines):
            nxt = self.lines[i]
            if nxt.indent > indent or (seq_at_indent and
                                       nxt.indent == indent and
                                       self.is_entry(nxt)):
                return self.node(i)
        return None, i

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            line = self.lines[i]
            key, pos = self.split_key(line)
            if pos < 0:
                self.fail(line.no, f"expected a mapping key at {line.text!r}")
            pos = self.skip(line.text, pos)
            if pos == len(line.text) or line.text[pos] == "#":
                value, i = self.child(i + 1, indent, seq_at_indent=True)
            else:
                if self.is_entry(_Line(line.no, 0, line.text[pos:])):
                    self.fail(line.no, "a block sequence cannot open on its "
                                       "key's line")
                value, end = self.node_inline(line, pos)
                self.end_of_node(line, end)
                i += 1
                if i < len(self.lines) and self.lines[i].indent > indent:
                    self.fail(self.lines[i].no, "a value that goes on past "
                                                "its line")
            out[key] = value
        if i < len(self.lines) and self.lines[i].indent > indent:
            self.fail(self.lines[i].no, "bad indentation")
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out = []
        while i < len(self.lines) and self.lines[i].indent == indent and \
                self.is_entry(self.lines[i]):
            line = self.lines[i]
            pos = self.skip(line.text, 1)
            if pos == len(line.text) or line.text[pos] == "#":
                value, i = self.child(i + 1, indent, seq_at_indent=False)
            else:
                # the entry's content opens a node at its own column
                self.lines[i] = _Line(line.no, indent + pos, line.text[pos:])
                value, i = self.node(i)
            out.append(value)
        if i < len(self.lines) and self.lines[i].indent > indent:
            self.fail(self.lines[i].no, "bad indentation")
        return out, i

    def document(self):
        if self.inline is not None:
            value, end = self.node_inline(self.inline, 0)
            self.end_of_node(self.inline, end)
            return value
        if not self.lines:
            return None
        value, i = self.node(0)
        if i < len(self.lines):
            self.fail(self.lines[i].no, "content after the document's "
                                        "top-level node")
        return value


def safe_load(text: str) -> Any:
    """The document in ``text``, as ``yaml.safe_load`` reads it (within the
    subset; anything else raises ``ValueError``)."""
    return _Reader(text).document()


def dump_scalar(v) -> str:
    """A scalar as ``yaml.safe_dump`` writes it (floats keep a dot before
    the exponent, as YAML 1.1 needs); strings double-quoted."""
    if hasattr(v, "item") and not isinstance(v, str):
        v = v.item()            # a numpy or torch scalar
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    return json.dumps(str(v))


_PLAIN_KEY = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_./-]*\Z")


def _dump_key(k) -> str:
    if isinstance(k, str) and _PLAIN_KEY.match(k) and \
            resolve_plain(k) == k:
        return k
    return dump_scalar(k)


def safe_dump_flat(mapping: Mapping) -> str:
    """``mapping`` (keys and values scalars) as a YAML block mapping, one
    ``key: value`` line each, in sorted key order."""
    for k, v in mapping.items():
        if isinstance(v, (dict, list, tuple)):
            raise ValueError(f"{k!r}: not a scalar ({type(v).__name__})")
    return "".join(f"{_dump_key(k)}: {dump_scalar(mapping[k])}\n"
                   for k in sorted(mapping))
