"""Minimal protobuf text-format parser for NetParameter prototxt files (a
pure-Python copy of ``nct_tpu/nn/prototxt.py``).

Replaces Caffe's protobuf TextFormat dependency (reference: net.cpp:49
ReadNetParamsFromTextFileOrDie) with a ~100-line recursive reader good for
the message shapes that appear in deploy prototxts: scalar fields, repeated
fields, nested messages, quoted strings, and enum tokens.
"""

from __future__ import annotations

import re

_TOKEN = re.compile(
    r"""
    \s*(?:
        (?P<comment>\#[^\n]*)
      | (?P<brace>[{}])
      | (?P<colon>:)
      | (?P<string>"(?:[^"\\]|\\.)*")
      | (?P<atom>[A-Za-z0-9_.+-]+)
    )
    """,
    re.VERBOSE,
)


def _tokenize(text: str):
    pos = 0
    n = len(text)
    while pos < n:
        if text[pos].isspace():
            pos += 1
            continue
        m = _TOKEN.match(text, pos)
        if not m:
            raise ValueError(f"prototxt parse error at char {pos}")
        pos = m.end()
        if m.lastgroup == "comment":
            continue
        yield m.lastgroup, m.group(m.lastgroup)
    yield "eof", ""


def _coerce(tok: str):
    if tok.startswith('"'):
        return tok[1:-1].encode().decode("unicode_escape")
    if re.fullmatch(r"[+-]?\d+", tok):
        return int(tok)
    if re.fullmatch(r"[+-]?(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?", tok):
        return float(tok)
    if tok in ("true", "false"):
        return tok == "true"
    return tok  # enum token / bare string


class _Parser:
    def __init__(self, text: str):
        self._toks = _tokenize(text)
        self._peeked = None

    def _next(self):
        if self._peeked is not None:
            t, self._peeked = self._peeked, None
            return t
        return next(self._toks)

    def _peek(self):
        if self._peeked is None:
            self._peeked = next(self._toks)
        return self._peeked

    def parse_message(self, top_level: bool = False) -> dict:
        """Returns {field: value-or-list}; repeated fields become lists."""
        out: dict = {}
        while True:
            kind, tok = self._peek()
            if kind == "eof" or (kind == "brace" and tok == "}"):
                if not top_level:
                    self._next()  # consume '}'
                return out
            kind, tok = self._next()
            if kind != "atom":
                raise ValueError(f"expected field name, got {tok!r}")
            field = tok
            kind, tok2 = self._peek()
            if kind == "brace" and tok2 == "{":
                self._next()
                val = self.parse_message()
            elif kind == "colon":
                self._next()
                _, vtok = self._next()
                val = _coerce(vtok)
            else:
                raise ValueError(f"expected ':' or '{{' after {field!r}")
            if field in out:
                if not isinstance(out[field], list):
                    out[field] = [out[field]]
                out[field].append(val)
            else:
                out[field] = val
        return out


def parse_prototxt(text: str) -> dict:
    """Parse NetParameter text; 'layer'/'layers' are always lists."""
    p = _Parser(text)
    msg = p.parse_message(top_level=True)
    for key in ("layer", "layers", "input", "input_shape"):
        if key in msg and not isinstance(msg[key], list):
            msg[key] = [msg[key]]
    return msg


def load_prototxt(path: str) -> dict:
    with open(path) as f:
        return parse_prototxt(f.read())
