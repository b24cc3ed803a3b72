"""Parser for the Palgol surface syntax (paper Fig. 2).

Palgol is indentation-based; the tokenizer synthesizes INDENT/DEDENT tokens
(the paper's '(' / ')' layout tokens) from leading whitespace, and a
recursive-descent parser builds the AST.

Grammar (as implemented — faithful to Fig. 2 + §3.4):

    prog   := item+
    item   := step | iter | stopstep
    step   := "for" var "in" "V" NEWLINE INDENT stmt+ DEDENT "end"
    stop   := "stop" var "in" "V" "if" exp
    iter   := "do" NEWLINE INDENT item+ DEDENT "until" "fix" "[" fields "]"
    stmt   := "if" exp block ("else" block)?
            | "for" "(" var "<-" exp ")" block
            | "let" var "=" exp
            | "local" field "[" var "]" op_local exp
            | "remote" field "[" exp "]" op_remote exp
    exp    := ternary with the usual precedence chain; primaries include
              literals, vars, field access F[e], e.id / e.w, comprehensions
              ``func [ exp | var <- exp, filters ]``, and parens.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from repro_torch.core import ast

_TOKEN_RE = re.compile(
    r"""
    (?P<float>\d+\.\d+(e[+-]?\d+)?|\d+e[+-]?\d+)
  | (?P<int>\d+)
  | (?P<name>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><\?=|>\?=|\|\|=|&&=|\+=|-=|\*=|/=|:=|<-|==|!=|<=|>=|\|\||&&|[-+*/%<>=!?:,.|\[\]()])
  | (?P<ws>[ \t]+)
  | (?P<comment>\#[^\n]*|//[^\n]*)
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "for", "in", "V", "end", "do", "until", "fix", "if", "else", "let",
    "local", "remote", "stop", "true", "false", "inf",
}
_REDUCE_FUNCS = ast.REDUCE_FUNCS
_EDGE_LISTS = {"Nbr": "nbr", "In": "in", "Out": "out"}


class Token:
    __slots__ = ("kind", "value", "line")

    def __init__(self, kind, value, line):
        self.kind, self.value, self.line = kind, value, line

    def __repr__(self):
        return f"{self.kind}:{self.value!r}@{self.line}"


class PalgolSyntaxError(SyntaxError):
    pass


def tokenize(source: str) -> List[Token]:
    tokens: List[Token] = []
    indents = [0]
    for lineno, raw in enumerate(source.splitlines(), start=1):
        line = raw.rstrip()
        stripped = line.lstrip(" \t")
        if not stripped or stripped.startswith("#") or stripped.startswith("//"):
            continue
        indent = len(line) - len(stripped)
        if indent > indents[-1]:
            indents.append(indent)
            tokens.append(Token("INDENT", indent, lineno))
        while indent < indents[-1]:
            indents.pop()
            tokens.append(Token("DEDENT", indent, lineno))
        if indent != indents[-1]:
            raise PalgolSyntaxError(f"line {lineno}: inconsistent dedent")
        pos = 0
        while pos < len(stripped):
            m = _TOKEN_RE.match(stripped, pos)
            if not m:
                raise PalgolSyntaxError(
                    f"line {lineno}: cannot tokenize {stripped[pos:pos+10]!r}"
                )
            pos = m.end()
            kind = m.lastgroup
            if kind in ("ws", "comment"):
                continue
            val = m.group()
            if kind == "name":
                if val in _KEYWORDS:
                    tokens.append(Token(val, val, lineno))
                else:
                    tokens.append(Token("NAME", val, lineno))
            elif kind == "int":
                tokens.append(Token("INT", int(val), lineno))
            elif kind == "float":
                tokens.append(Token("FLOAT", float(val), lineno))
            else:
                tokens.append(Token("OP", val, lineno))
        tokens.append(Token("NEWLINE", None, lineno))
    while len(indents) > 1:
        indents.pop()
        tokens.append(Token("DEDENT", 0, -1))
    tokens.append(Token("EOF", None, -1))
    return tokens


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    # -- token helpers -----------------------------------------------------
    def peek(self, k=0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind, value=None) -> Token:
        t = self.next()
        if t.kind != kind or (value is not None and t.value != value):
            raise PalgolSyntaxError(
                f"line {t.line}: expected {value or kind}, got {t.kind}:{t.value!r}"
            )
        return t

    def accept(self, kind, value=None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def skip_newlines(self):
        while self.peek().kind == "NEWLINE":
            self.next()

    # -- program -----------------------------------------------------------
    def parse_program(self) -> ast.Prog:
        items = self.parse_items(until=("EOF",))
        self.expect("EOF")
        if len(items) == 1:
            return items[0]
        return ast.Seq(tuple(items))

    def parse_items(self, until: Tuple[str, ...]) -> List[ast.Prog]:
        items: List[ast.Prog] = []
        self.skip_newlines()
        while self.peek().kind not in until:
            items.append(self.parse_item())
            self.skip_newlines()
        return items

    def parse_item(self) -> ast.Prog:
        t = self.peek()
        if t.kind == "for":
            return self.parse_step()
        if t.kind == "do":
            return self.parse_iter()
        if t.kind == "stop":
            return self.parse_stop()
        raise PalgolSyntaxError(
            f"line {t.line}: expected step/do/stop, got {t.value!r}"
        )

    def parse_step(self) -> ast.Step:
        self.expect("for")
        var = self.expect("NAME").value
        self.expect("in")
        self.expect("V")
        self.expect("NEWLINE")
        self.expect("INDENT")
        body = self.parse_block_stmts()
        self.expect("DEDENT")
        self.expect("end")
        self.accept("NEWLINE")
        return ast.Step(var, tuple(body))

    def parse_stop(self) -> ast.StopStep:
        self.expect("stop")
        var = self.expect("NAME").value
        self.expect("in")
        self.expect("V")
        self.expect("if")
        cond = self.parse_expr()
        self.accept("NEWLINE")
        return ast.StopStep(var, cond)

    def parse_iter(self) -> ast.Iter:
        self.expect("do")
        self.expect("NEWLINE")
        self.expect("INDENT")
        items = self.parse_items(until=("DEDENT",))
        self.expect("DEDENT")
        self.expect("until")
        body_items = items
        body = body_items[0] if len(body_items) == 1 else ast.Seq(tuple(body_items))
        if self.peek().kind == "fix":
            self.next()
            self.expect("OP", "[")
            fields = [self.expect("NAME").value]
            while self.accept("OP", ","):
                fields.append(self.expect("NAME").value)
            self.expect("OP", "]")
            self.accept("NEWLINE")
            return ast.Iter(body, tuple(fields))
        t = self.expect("NAME")
        if t.value != "iter":
            raise PalgolSyntaxError(
                f"line {t.line}: expected 'fix' or 'iter' after until"
            )
        self.expect("OP", "[")
        k = self.expect("INT").value
        self.expect("OP", "]")
        self.accept("NEWLINE")
        return ast.Iter(body, (), fixed_trips=int(k))

    # -- statements ---------------------------------------------------------
    def parse_block_stmts(self) -> List[ast.Stmt]:
        stmts: List[ast.Stmt] = []
        self.skip_newlines()
        while self.peek().kind not in ("DEDENT", "EOF"):
            stmts.append(self.parse_stmt())
            self.skip_newlines()
        return stmts

    def parse_indented_block(self) -> Tuple[ast.Stmt, ...]:
        self.expect("NEWLINE")
        self.expect("INDENT")
        stmts = self.parse_block_stmts()
        self.expect("DEDENT")
        return tuple(stmts)

    def parse_stmt(self) -> ast.Stmt:
        t = self.peek()
        if t.kind == "if":
            self.next()
            cond = self.parse_expr()
            then = self.parse_indented_block()
            other: Tuple[ast.Stmt, ...] = ()
            if self.peek().kind == "else":
                self.next()
                other = self.parse_indented_block()
            return ast.If(cond, then, other)
        if t.kind == "for":
            self.next()
            self.expect("OP", "(")
            var = self.expect("NAME").value
            self.expect("OP", "<-")
            rng = self.parse_expr()
            self.expect("OP", ")")
            if not isinstance(rng, ast.EdgeList):
                raise PalgolSyntaxError(
                    f"line {t.line}: for-loop range must be Nbr/In/Out[...]"
                )
            body = self.parse_indented_block()
            return ast.ForEdges(var, rng, body)
        if t.kind == "let":
            self.next()
            var = self.expect("NAME").value
            self.expect("OP", "=")
            value = self.parse_expr()
            self.accept("NEWLINE")
            return ast.Let(var, value)
        if t.kind == "local":
            self.next()
            field = self.expect("NAME").value
            self.expect("OP", "[")
            idx_var = self.expect("NAME").value  # validated in analysis
            self.expect("OP", "]")
            op = self.expect("OP").value
            if op not in ast.LOCAL_OPS:
                raise PalgolSyntaxError(f"line {t.line}: bad local op {op!r}")
            value = self.parse_expr()
            self.accept("NEWLINE")
            return ast.LocalWrite(field, op, value, idx_var)
        if t.kind == "remote":
            self.next()
            field = self.expect("NAME").value
            self.expect("OP", "[")
            target = self.parse_expr()
            self.expect("OP", "]")
            op = self.expect("OP").value
            if op not in ast.REMOTE_OPS:
                raise PalgolSyntaxError(
                    f"line {t.line}: remote writes must be accumulative, got {op!r}"
                )
            value = self.parse_expr()
            self.accept("NEWLINE")
            return ast.RemoteWrite(field, target, op, value)
        raise PalgolSyntaxError(f"line {t.line}: unexpected {t.value!r}")

    # -- expressions ----------------------------------------------------------
    def parse_expr(self) -> ast.Expr:
        return self.parse_ternary()

    def parse_ternary(self) -> ast.Expr:
        cond = self.parse_or()
        if self.accept("OP", "?"):
            then = self.parse_ternary()
            self.expect("OP", ":")
            other = self.parse_ternary()
            return ast.Cond(cond, then, other)
        return cond

    def parse_or(self) -> ast.Expr:
        left = self.parse_and()
        while self.accept("OP", "||"):
            left = ast.BinOp("||", left, self.parse_and())
        return left

    def parse_and(self) -> ast.Expr:
        left = self.parse_cmp()
        while self.accept("OP", "&&"):
            left = ast.BinOp("&&", left, self.parse_cmp())
        return left

    def parse_cmp(self) -> ast.Expr:
        left = self.parse_add()
        t = self.peek()
        if t.kind == "OP" and t.value in ("==", "!=", "<", "<=", ">", ">="):
            self.next()
            return ast.BinOp(t.value, left, self.parse_add())
        return left

    def parse_add(self) -> ast.Expr:
        left = self.parse_mul()
        while True:
            t = self.peek()
            if t.kind == "OP" and t.value in ("+", "-"):
                self.next()
                left = ast.BinOp(t.value, left, self.parse_mul())
            else:
                return left

    def parse_mul(self) -> ast.Expr:
        left = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "OP" and t.value in ("*", "/", "%"):
                self.next()
                left = ast.BinOp(t.value, left, self.parse_unary())
            else:
                return left

    def parse_unary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "OP" and t.value in ("!", "-"):
            self.next()
            return ast.UnOp(t.value, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self) -> ast.Expr:
        e = self.parse_primary()
        while self.peek().kind == "OP" and self.peek().value == ".":
            self.next()
            prop = self.expect("NAME").value
            if prop not in ("id", "w"):
                raise PalgolSyntaxError(f"unknown edge property .{prop}")
            if not isinstance(e, ast.Var):
                raise PalgolSyntaxError(".id/.w only valid on edge variables")
            e = ast.EdgeProp(e.name, prop)
        return e

    def parse_primary(self) -> ast.Expr:
        t = self.next()
        if t.kind == "INT" or t.kind == "FLOAT":
            return ast.Const(t.value)
        if t.kind == "true":
            return ast.Const(True)
        if t.kind == "false":
            return ast.Const(False)
        if t.kind == "inf":
            return ast.Const("inf")
        if t.kind == "OP" and t.value == "(":
            e = self.parse_expr()
            self.expect("OP", ")")
            return e
        if t.kind == "NAME":
            name = t.value
            # reduce comprehension: func [ body | var <- range, filters ]
            if (
                name in _REDUCE_FUNCS
                and self.peek().kind == "OP"
                and self.peek().value == "["
            ):
                self.next()  # [
                body = self.parse_expr()
                self.expect("OP", "|")
                var = self.expect("NAME").value
                self.expect("OP", "<-")
                rng = self.parse_expr()
                if not isinstance(rng, ast.EdgeList):
                    raise PalgolSyntaxError(
                        f"line {t.line}: comprehension range must be Nbr/In/Out[...]"
                    )
                filters = []
                while self.accept("OP", ","):
                    filters.append(self.parse_expr())
                self.expect("OP", "]")
                return ast.Reduce(name, body, var, rng, tuple(filters))
            # edge lists / field access: Capitalized [ exp ]
            if self.peek().kind == "OP" and self.peek().value == "[":
                if not name[0].isupper():
                    raise PalgolSyntaxError(
                        f"line {t.line}: lowercase {name!r} cannot be indexed; "
                        "fields start with a capital letter"
                    )
                self.next()  # [
                idx = self.parse_expr()
                self.expect("OP", "]")
                if name in _EDGE_LISTS:
                    return ast.EdgeList(_EDGE_LISTS[name], idx)
                return ast.FieldAccess(name, idx)
            if name[0].isupper():
                raise PalgolSyntaxError(
                    f"line {t.line}: field {name!r} must be indexed (Field[expr])"
                )
            return ast.Var(name)
        raise PalgolSyntaxError(f"line {t.line}: unexpected token {t.value!r}")


def parse(source: str) -> ast.Prog:
    """Parse Palgol source text into an AST."""
    return Parser(tokenize(source)).parse_program()
