"""A reader for the YAML subset of the hyperparameter search spaces
(``config/hpo/*.yaml``), written out because the card machine has no YAML
package. ``load(text)`` equals ``yaml.safe_load(text)`` (PyYAML, YAML 1.1)
on that subset:

- block mappings, block sequences (also at their key's indentation), and
  mappings inside sequence items (``- cond_type: eq`` with more keys
  below it);
- flow sequences on one line (``[1.0e-5, 1.0e-3]``, nested ones too);
- plain, single-quoted and double-quoted scalars on one line, such as
  paths;
- ``#`` comments on their own lines and after a value.

Plain scalars resolve as PyYAML's ``safe_load`` resolves them: ``1.0e-5``
is a float but ``1e-5`` (no dot) and ``1.0e5`` (no exponent sign) are
strings; ``true/false/yes/no/on/off`` in their three capitalisations are
booleans; ``null``, ``~`` and an empty value are None; ints take ``0b``,
``0x``, octal ``0…``, ``_`` separators and base-60 ``1:30``.

Everything else raises ``ValueError`` naming its line: anchors, aliases,
tags, block and multi-line scalars, flow mappings, multi-line flow
sequences, complex keys, directives, document markers, timestamps, tabs
in the indentation. It never guesses.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_UNSUPPORTED_START = {
    "&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
    ">": "block scalars", "%": "directives", "@": "reserved indicators",
    "`": "reserved indicators", "{": "flow mappings",
}
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r",
            "0": "\0", " ": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _base60(value: str, cast):
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def resolve_plain(text: str, line: int) -> Any:
    """A plain scalar's value under PyYAML 1.1's implicit resolvers (bool,
    float, int, null, in that order of precedence), else the string."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * (_base60(v, float) if ":" in v else float(v))
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_base60(v, int) if ":" in v else int(v))
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        raise ValueError(f"line {line}: timestamps are not supported: {text!r}")
    if text in ("<<", "="):
        raise ValueError(f"line {line}: merge and value keys are not supported")
    return text


class _Reader:
    def __init__(self, text: str):
        text = text.lstrip("﻿")
        self.lines: List[str] = [ln.rstrip("\r") for ln in text.split("\n")]
        for i, ln in enumerate(self.lines):
            body = ln.lstrip(" ")
            if body.startswith("\t"):
                self.fail(i, "tabs in the indentation are not supported")
            if ln.startswith(("---", "...")) and ln[3:4] in ("", " ", "\t"):
                self.fail(i, "document markers are not supported")

    @staticmethod
    def fail(i: int, msg: str):
        raise ValueError(f"line {i + 1}: {msg}")

    # ---- lines ------------------------------------------------------------
    def content(self, i: int) -> int:
        """The index of the first line at or after ``i`` holding content."""
        while i < len(self.lines):
            body = self.lines[i].strip(" \t")
            if body and not body.startswith("#"):
                return i
            i += 1
        return i

    def indent(self, i: int) -> int:
        ln = self.lines[i]
        return len(ln) - len(ln.lstrip(" "))

    # ---- one-line pieces --------------------------------------------------
    def rest_is_empty(self, i: int, col: int) -> bool:
        """Only spaces or a comment from ``col`` on."""
        tail = self.lines[i][col:]
        stripped = tail.lstrip(" \t")
        if "\t" in tail[:len(tail) - len(stripped)]:
            self.fail(i, "tabs between tokens are not supported")
        return not stripped or (stripped.startswith("#")
                                and (len(stripped) < len(tail) or col == 0
                                     or self.lines[i][col - 1] in " \t"))

    def skip_spaces(self, i: int, col: int) -> int:
        ln = self.lines[i]
        while col < len(ln) and ln[col] in " \t":
            if ln[col] == "\t":
                self.fail(i, "tabs between tokens are not supported")
            col += 1
        return col

    def quoted(self, i: int, col: int) -> Tuple[str, int]:
        """The quoted scalar starting at ``col`` and the column after it."""
        ln, q = self.lines[i], self.lines[i][col]
        out, j = [], col + 1
        while True:
            if j >= len(ln):
                self.fail(i, "multi-line quoted scalars are not supported")
            ch = ln[j]
            if q == "'":
                if ch == "'":
                    if ln[j + 1:j + 2] == "'":
                        out.append("'")
                        j += 2
                        continue
                    return "".join(out), j + 1
                out.append(ch)
                j += 1
                continue
            if ch == '"':
                return "".join(out), j + 1
            if ch == "\\":
                esc = ln[j + 1:j + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    j += 2
                elif esc in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[esc]
                    digits = ln[j + 2:j + 2 + n]
                    if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                        self.fail(i, f"bad escape \\{esc}{digits}")
                    out.append(chr(int(digits, 16)))
                    j += 2 + n
                else:
                    self.fail(i, f"unsupported escape \\{esc}")
                continue
            out.append(ch)
            j += 1

    def check_plain_start(self, i: int, col: int, flow: bool) -> None:
        ln = self.lines[i]
        ch, nxt = ln[col], ln[col + 1:col + 2]
        if ch in _UNSUPPORTED_START:
            self.fail(i, f"{_UNSUPPORTED_START[ch]} are not supported")
        if ch in "-?:" and nxt in ("", " ", "\t"):
            self.fail(i, f"{ch!r} indicator is not supported here")
        if ch in "?:" and flow:
            self.fail(i, f"{ch!r} in a flow sequence is not supported")
        if ch in ",]}" or ch == "#":
            self.fail(i, f"unexpected {ch!r}")

    def plain(self, i: int, col: int, flow: bool) -> Tuple[Any, int]:
        """A plain scalar from ``col`` to its end on this line (a comment,
        the line's end; in a flow sequence also ``,`` or ``]``)."""
        self.check_plain_start(i, col, flow)
        ln = self.lines[i]
        j = col
        while j < len(ln):
            ch = ln[j]
            nxt = ln[j + 1:j + 2]
            if ch == "#" and ln[j - 1] in " \t":
                break
            if ch == ":" and (nxt in ("", " ", "\t") or (flow and nxt in ",[]{}")):
                self.fail(i, "a ': ' inside a value (a nested mapping) is not "
                          "supported here")
            if flow and ch in ",]":
                break
            if flow and ch in "[{}?":
                self.fail(i, f"{ch!r} inside a flow scalar is not supported")
            j += 1
        if "\t" in ln[col:j]:
            self.fail(i, "tabs in or after a plain scalar are not supported")
        text = ln[col:j].rstrip(" ")
        return resolve_plain(text, i + 1), col + len(text)

    def flow_sequence(self, i: int, col: int) -> Tuple[list, int]:
        """``[a, b, [c]]`` starting at ``col`` on one line."""
        ln = self.lines[i]
        items, j = [], self.skip_spaces(i, col + 1)
        while True:
            if j >= len(ln) or ln[j] == "#":
                self.fail(i, "multi-line flow sequences are not supported")
            if ln[j] == "]":
                return items, j + 1
            if ln[j] == "[":
                value, j = self.flow_sequence(i, j)
            elif ln[j] in "'\"":
                value, j = self.quoted(i, j)
            else:
                value, j = self.plain(i, j, flow=True)
            items.append(value)
            j = self.skip_spaces(i, j)
            if j < len(ln) and ln[j] == ",":
                j = self.skip_spaces(i, j + 1)
            elif j >= len(ln) or ln[j] != "]":
                self.fail(i, "expected ',' or ']' in a flow sequence")

    def inline_value(self, i: int, col: int) -> Any:
        """A one-line value from ``col``: flow sequence, quoted or plain,
        then nothing but a comment."""
        ch = self.lines[i][col]
        if ch == "[":
            value, end = self.flow_sequence(i, col)
        elif ch in "'\"":
            value, end = self.quoted(i, col)
        else:
            value, end = self.plain(i, col, flow=False)
        if not self.rest_is_empty(i, end):
            self.fail(i, "unexpected content after a value")
        return value

    def key_at(self, i: int, col: int) -> Optional[Tuple[Any, int]]:
        """(key, column after its ':') if a mapping entry starts at
        ``col``, else None."""
        ln = self.lines[i]
        ch = ln[col]
        if ch == "?" and ln[col + 1:col + 2] in ("", " ", "\t"):
            self.fail(i, "complex keys are not supported")
        if ch in "'\"":
            key, j = self.quoted(i, col)
            j = self.skip_spaces(i, j)
            if j < len(ln) and ln[j] == ":" and ln[j + 1:j + 2] in ("", " ", "\t"):
                return key, j + 1
            return None
        if ch == "[" or ch == "-" and ln[col + 1:col + 2] in ("", " ", "\t"):
            return None
        j = col
        while j < len(ln):
            if ln[j] == "#" and j > col and ln[j - 1] in " \t":
                return None
            if ln[j] == ":" and ln[j + 1:j + 2] in ("", " ", "\t"):
                self.check_plain_start(i, col, flow=False)
                text = ln[col:j].rstrip(" \t")
                return resolve_plain(text, i + 1), j + 1
            j += 1
        return None

    # ---- blocks -------------------------------------------------------------
    def no_continuation(self, i: int, parent: int) -> int:
        """The next content line after a one-line value at line ``i``; a
        line indented deeper than ``parent`` would continue the value."""
        j = self.content(i + 1)
        if j < len(self.lines) and self.indent(j) > parent:
            self.fail(j, "multi-line scalars are not supported")
        return j

    def node(self, i: int, col: int, parent: int) -> Tuple[Any, int]:
        """The node starting at line ``i``, column ``col``, inside a block
        indented ``parent``; returns it and the next content line."""
        ln = self.lines[i]
        if ln[col] == "-" and ln[col + 1:col + 2] in ("", " ", "\t"):
            return self.sequence(i, col)
        if self.key_at(i, col) is not None:
            return self.mapping(i, col)
        return self.inline_value(i, col), self.no_continuation(i, parent)

    def nested(self, i: int, col: int, allow_indentless: bool) -> Tuple[Any, int]:
        """The value of an entry whose line ends after its indicator: the
        block below it, indented deeper than ``col`` (for a mapping value
        also a sequence at ``col``), else None."""
        j = self.content(i + 1)
        if j < len(self.lines):
            ind = self.indent(j)
            if ind > col:
                return self.node(j, ind, col)
            body = self.lines[j][ind:]
            if allow_indentless and ind == col and (body == "-" or body[:2] in ("- ", "-\t")):
                return self.sequence(j, col)
        return None, j

    def sequence(self, i: int, col: int) -> Tuple[list, int]:
        items = []
        first = True
        while i < len(self.lines) and (first or self.indent(i) == col):
            first = False
            ln = self.lines[i]
            if not (ln[col] == "-" and ln[col + 1:col + 2] in ("", " ", "\t")):
                break
            start = self.skip_spaces(i, col + 1)
            if self.rest_is_empty(i, start):
                value, i = self.nested(i, col, allow_indentless=False)
            else:
                value, i = self.node(i, start, col)
            items.append(value)
        if i < len(self.lines) and self.indent(i) > col:
            self.fail(i, "bad indentation in a block sequence")
        return items, i

    def mapping(self, i: int, col: int) -> Tuple[dict, int]:
        out = {}
        first = True
        while i < len(self.lines) and (first or self.indent(i) == col):
            found = self.key_at(i, col)
            if found is None:
                if self.lines[i][col] == "-":
                    break  # an indentless sequence's end: the caller's
                self.fail(i, "expected a 'key: value' entry")
            key, after = found
            if isinstance(key, list):
                self.fail(i, "unhashable key")
            start = self.skip_spaces(i, after)
            if self.rest_is_empty(i, start):
                value, i = self.nested(i, col, allow_indentless=True)
            else:
                value = self.inline_value(i, start)
                i = self.no_continuation(i, col)
            out[key] = value  # a repeated key: the last wins, as in PyYAML
            first = False
        if i < len(self.lines) and self.indent(i) > col:
            self.fail(i, "bad indentation in a block mapping")
        return out, i

    def document(self) -> Any:
        i = self.content(0)
        if i >= len(self.lines):
            return None
        value, i = self.node(i, self.indent(i), -1)
        if i < len(self.lines):
            self.fail(i, "unexpected content after the document")
        return value


def load(text: str) -> Any:
    """The value of a YAML document in the supported subset (module
    docstring), as ``yaml.safe_load`` gives it; ``ValueError`` with the
    line number outside the subset."""
    return _Reader(text).document()
