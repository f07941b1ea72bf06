"""PQL lexer.

Parity: token vocabulary of pinot-common/src/main/antlr4/.../PQL2.g4 —
identifiers (optionally back-quoted), string literals ('..' or ".."), integer
and float literals, comparison operators, parens/commas/star, and the PQL
keyword set (case-insensitive).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List


class TokType(enum.Enum):
    IDENT = "IDENT"
    STRING = "STRING"
    INT = "INT"
    FLOAT = "FLOAT"
    OP = "OP"          # = <> != < <= > >=
    LPAREN = "LPAREN"
    RPAREN = "RPAREN"
    LBRACKET = "LBRACKET"
    RBRACKET = "RBRACKET"
    COMMA = "COMMA"
    STAR = "STAR"
    KEYWORD = "KEYWORD"
    EOF = "EOF"


KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "TOP",
    "LIMIT", "OFFSET", "AND", "OR", "NOT", "IN", "BETWEEN", "IS", "NULL",
    "ASC", "DESC", "OPTION", "JOIN", "ON", "OVER", "PARTITION",
}


@dataclasses.dataclass
class Token:
    type: TokType
    value: str
    pos: int

    @property
    def upper(self) -> str:
        return self.value.upper()


class PqlSyntaxError(ValueError):
    pass


def tokenize(text: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c.isspace():
            i += 1
            continue
        if c in "'\"":
            quote = c
            j = i + 1
            buf = []
            while j < n:
                if text[j] == quote:
                    if j + 1 < n and text[j + 1] == quote:  # escaped quote
                        buf.append(quote)
                        j += 2
                        continue
                    break
                buf.append(text[j])
                j += 1
            else:
                raise PqlSyntaxError(f"unterminated string at {i}")
            toks.append(Token(TokType.STRING, "".join(buf), i))
            i = j + 1
            continue
        if c == "`":
            j = text.find("`", i + 1)
            if j < 0:
                raise PqlSyntaxError(f"unterminated back-quote at {i}")
            toks.append(Token(TokType.IDENT, text[i + 1:j], i))
            i = j + 1
            continue
        if c.isdigit() or (c in "+-." and i + 1 < n and text[i + 1].isdigit()
                           and _numeric_context(toks)):
            j = i
            if text[j] in "+-":
                j += 1
            seen_dot = seen_exp = False
            while j < n and (text[j].isdigit() or text[j] in ".eE+-"):
                if text[j] == ".":
                    if seen_dot:
                        break
                    seen_dot = True
                elif text[j] in "eE":
                    if seen_exp:
                        break
                    seen_exp = True
                elif text[j] in "+-" and text[j - 1] not in "eE":
                    break
                j += 1
            lit = text[i:j]
            ttype = TokType.FLOAT if ("." in lit or "e" in lit or "E" in lit) \
                else TokType.INT
            toks.append(Token(ttype, lit, i))
            i = j
            continue
        if c.isalpha() or c in "_$":
            j = i
            while j < n and (text[j].isalnum() or text[j] in "_$."):
                j += 1
            word = text[i:j]
            ttype = TokType.KEYWORD if word.upper() in KEYWORDS else TokType.IDENT
            toks.append(Token(ttype, word, i))
            i = j
            continue
        if c == "(":
            toks.append(Token(TokType.LPAREN, c, i)); i += 1; continue
        if c == ")":
            toks.append(Token(TokType.RPAREN, c, i)); i += 1; continue
        if c == "[":
            toks.append(Token(TokType.LBRACKET, c, i)); i += 1; continue
        if c == "]":
            toks.append(Token(TokType.RBRACKET, c, i)); i += 1; continue
        if c == ",":
            toks.append(Token(TokType.COMMA, c, i)); i += 1; continue
        if c == "*":
            toks.append(Token(TokType.STAR, c, i)); i += 1; continue
        if c in "=<>!":
            for op in ("<>", "<=", ">=", "!=", "=", "<", ">"):
                if text.startswith(op, i):
                    toks.append(Token(TokType.OP, op, i))
                    i += len(op)
                    break
            else:
                raise PqlSyntaxError(f"bad operator at {i}: {text[i:i+2]!r}")
            continue
        raise PqlSyntaxError(f"unexpected character {c!r} at {i}")
    toks.append(Token(TokType.EOF, "", n))
    return toks


def _numeric_context(toks: List[Token]) -> bool:
    """A leading +/- starts a number only after an operator/paren/comma/keyword."""
    if not toks:
        return True
    return toks[-1].type in (TokType.OP, TokType.LPAREN, TokType.COMMA,
                             TokType.KEYWORD, TokType.LBRACKET)
