# Verbatim copy of datafusion_tpu/sql/lexer.py; host-only, kept in step with the original.
"""SQL tokenizer (reference capability: sqlparser-rs tokenizer as used via
DFParser, datafusion/sql/src/parser.rs)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..common.errors import ParseError

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "exists", "between", "like",
    "ilike", "is", "null", "true", "false", "case", "when", "then", "else",
    "end", "cast", "try_cast", "join", "inner", "left", "right", "full",
    "outer", "cross", "on", "using", "union", "all", "distinct", "except",
    "intersect", "with", "recursive", "asc", "desc", "nulls", "first", "last",
    "interval", "date", "timestamp", "time", "extract", "substring", "for",
    "create", "table", "external", "drop", "insert", "into", "values", "view",
    "explain", "analyze", "describe", "show", "set", "copy", "to", "stored",
    "location", "options", "header", "delimiter", "partitioned", "if",
    "replace", "any", "some", "escape", "filter", "over", "partition", "rows",
    "range", "groups", "unbounded", "preceding", "following", "current", "row",
}


@dataclasses.dataclass
class Token:
    kind: str  # kw, ident, number, string, op, eof
    value: str
    pos: int

    def __repr__(self):
        return f"{self.kind}:{self.value}"


_TWO_CHAR_OPS = {"<>", "!=", ">=", "<=", "||", "::", "->"}
_ONE_CHAR_OPS = set("+-*/%(),.;=<>[]")


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        ch = sql[i]
        if ch.isspace():
            i += 1
            continue
        if ch == "-" and i + 1 < n and sql[i + 1] == "-":  # line comment
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if ch == "/" and i + 1 < n and sql[i + 1] == "*":  # block comment
            j = sql.find("*/", i + 2)
            if j < 0:
                raise ParseError("unterminated block comment")
            i = j + 2
            continue
        if ch in "xX" and i + 1 < n and sql[i + 1] == "'":
            # hex byte-string literal X'1A2B' -> bytes token
            j = sql.find("'", i + 2)
            if j < 0:
                raise ParseError("unterminated hex literal")
            hexs = sql[i + 2:j].strip()
            if not all(c in "0123456789abcdefABCDEF" for c in hexs):
                raise ParseError(f"invalid hex literal X'{hexs}'")
            if len(hexs) % 2:  # odd digit count: left-pad (X'ABC' = 0x0ABC)
                hexs = "0" + hexs
            out.append(Token("bytes", hexs.lower(), i))
            i = j + 1
            continue
        if ch == "'":
            j = i + 1
            buf = []
            while j < n:
                if sql[j] == "'" and j + 1 < n and sql[j + 1] == "'":
                    buf.append("'")
                    j += 2
                elif sql[j] == "'":
                    break
                else:
                    buf.append(sql[j])
                    j += 1
            if j >= n:
                raise ParseError("unterminated string literal")
            out.append(Token("string", "".join(buf), i))
            i = j + 1
            continue
        if ch == '"':
            j = sql.find('"', i + 1)
            if j < 0:
                raise ParseError("unterminated quoted identifier")
            out.append(Token("ident", sql[i + 1:j], i))
            i = j + 1
            continue
        if ch.isdigit() or (ch == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_e = False
            while j < n:
                c = sql[j]
                if c.isdigit():
                    j += 1
                elif c == "." and not seen_dot and not seen_e:
                    seen_dot = True
                    j += 1
                elif c in "eE" and not seen_e and j + 1 < n and (sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                    seen_e = True
                    j += 2
                else:
                    break
            out.append(Token("number", sql[i:j], i))
            i = j
            continue
        if ch.isalpha() or ch == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j]
            lw = word.lower()
            if lw in KEYWORDS:
                out.append(Token("kw", lw, i))
            else:
                out.append(Token("ident", word, i))
            i = j
            continue
        two = sql[i:i + 2]
        if two in _TWO_CHAR_OPS:
            out.append(Token("op", two, i))
            i += 2
            continue
        if ch in _ONE_CHAR_OPS:
            out.append(Token("op", ch, i))
            i += 1
            continue
        if ch == "$" and i + 1 < n and sql[i + 1].isdigit():
            j = i + 1
            while j < n and sql[j].isdigit():
                j += 1
            out.append(Token("param", sql[i:j], i))  # $1, $2, ... placeholders
            i = j
            continue
        raise ParseError(f"unexpected character {ch!r} at {i}")
    out.append(Token("eof", "", n))
    return out
