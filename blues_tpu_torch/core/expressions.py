"""A Lepton-compatible expression compiler targeting PyTorch.

The port's copy of ``blues_tpu.core.expressions``: the same tokenizer,
parser, ``;`` definitions resolved in dependency order, ``variables`` and
error types and messages, with the functions mapped to torch ops, so a
compiled expression evaluates on tensors of any device and differentiates
with autograd. Python numbers work as well as tensors: a function given
only numbers computes on float64 CPU tensors (the NCMC schedule evaluates
its strings at a float lambda), and numbers beside a tensor take its dtype
and device.

Grammar (Lepton subset):

    expr    := term (('+'|'-') term)*
    term    := unary (('*'|'/') unary)*
    unary   := ('-'|'+') unary | power
    power   := atom ('^' unary)?
    atom    := NUMBER | NAME | NAME '(' expr (',' expr)* ')' | '(' expr ')'

Multiple statements are separated by ';'. Following Lepton, later
statements define named intermediates for earlier ones:
``"a+b; a=x^2; b=y"`` evaluates ``x^2 + y``.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Mapping

import torch

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<op>\^|[-+*/(),=]))"
)


def _tensors(*xs):
    """The arguments as tensors: numbers take the dtype and device of the
    first floating tensor among them, else float64 on the CPU."""
    like = next((x for x in xs if torch.is_tensor(x) and x.is_floating_point()), None)
    dtype = torch.float64 if like is None else like.dtype
    device = None if like is None else like.device
    return [
        x.to(dtype) if torch.is_tensor(x) and not x.is_floating_point()
        else x if torch.is_tensor(x)
        else torch.as_tensor(x, dtype=dtype, device=device)
        for x in xs
    ]


def _unary(op):
    return lambda x: op(*_tensors(x))


def _step(x):
    """Lepton step(x) = 0 if x < 0 else 1."""
    (x,) = _tensors(x)
    return (x >= 0).to(x.dtype)


def _delta(x):
    """Lepton delta(x) = 1 if x == 0 else 0."""
    (x,) = _tensors(x)
    return (x == 0).to(x.dtype)


def _select(x, y, z):
    """select(x, y, z) = z if x == 0 else y."""
    x, y, z = _tensors(x, y, z)
    return torch.where(x == 0, z, y)


_FUNCTIONS: dict[str, Callable] = {
    "sqrt": _unary(torch.sqrt),
    "exp": _unary(torch.exp),
    "log": _unary(torch.log),
    "sin": _unary(torch.sin),
    "cos": _unary(torch.cos),
    "tan": _unary(torch.tan),
    "asin": _unary(torch.asin),
    "acos": _unary(torch.acos),
    "atan": _unary(torch.atan),
    "sinh": _unary(torch.sinh),
    "cosh": _unary(torch.cosh),
    "tanh": _unary(torch.tanh),
    "erf": _unary(torch.erf),
    # 1 - erf(x), as the JAX package computes it
    "erfc": _unary(lambda x: 1.0 - torch.erf(x)),
    "abs": _unary(torch.abs),
    "floor": _unary(torch.floor),
    "ceil": _unary(torch.ceil),
    "min": lambda a, b: torch.minimum(*_tensors(a, b)),
    "max": lambda a, b: torch.maximum(*_tensors(a, b)),
    "step": _step,
    "delta": _delta,
    "select": _select,
}

_CONSTANTS = {"pi": math.pi}


def _tokenize(text: str) -> list[tuple[str, str]]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None or m.end() == pos:
            if text[pos:].strip() == "":
                break
            raise ValueError(f"cannot tokenize expression at: {text[pos:]!r}")
        pos = m.end()
        if m.group("num") is not None:
            tokens.append(("num", m.group("num")))
        elif m.group("name") is not None:
            tokens.append(("name", m.group("name")))
        else:
            tokens.append(("op", m.group("op")))
    return tokens


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.tokens = tokens
        self.pos = 0

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else (None, None)

    def next(self):
        tok = self.peek()
        self.pos += 1
        return tok

    def expect(self, value: str):
        kind, val = self.next()
        if val != value:
            raise ValueError(f"expected {value!r}, got {val!r}")

    def parse(self):
        node = self.expr()
        if self.pos != len(self.tokens):
            raise ValueError(f"trailing tokens: {self.tokens[self.pos:]}")
        return node

    def expr(self):
        node = self.term()
        while self.peek() == ("op", "+") or self.peek() == ("op", "-"):
            _, op = self.next()
            rhs = self.term()
            node = ("binop", op, node, rhs)
        return node

    def term(self):
        node = self.unary()
        while self.peek() == ("op", "*") or self.peek() == ("op", "/"):
            _, op = self.next()
            rhs = self.unary()
            node = ("binop", op, node, rhs)
        return node

    def unary(self):
        if self.peek() == ("op", "-"):
            self.next()
            return ("neg", self.unary())
        if self.peek() == ("op", "+"):
            self.next()
            return self.unary()
        return self.power()

    def power(self):
        node = self.atom()
        if self.peek() == ("op", "^"):
            self.next()
            exponent = self.unary()  # right-assoc
            node = ("binop", "^", node, exponent)
        return node

    def atom(self):
        kind, val = self.next()
        if kind == "num":
            return ("const", float(val))
        if kind == "name":
            if self.peek() == ("op", "("):
                self.next()
                args = [self.expr()]
                while self.peek() == ("op", ","):
                    self.next()
                    args.append(self.expr())
                self.expect(")")
                return ("call", val, args)
            return ("var", val)
        if val == "(":
            node = self.expr()
            self.expect(")")
            return node
        raise ValueError(f"unexpected token {val!r}")


def _eval_node(node, env: Mapping[str, object]):
    kind = node[0]
    if kind == "const":
        return node[1]
    if kind == "var":
        name = node[1]
        if name in env:
            return env[name]
        if name in _CONSTANTS:
            return _CONSTANTS[name]
        raise KeyError(f"unknown variable {name!r} in expression")
    if kind == "neg":
        return -_eval_node(node[1], env)
    if kind == "binop":
        _, op, lhs, rhs = node
        a = _eval_node(lhs, env)
        b = _eval_node(rhs, env)
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            return a / b
        if op == "^":
            # integer powers stay exact and cheap under autograd
            if isinstance(b, float) and b == int(b) and abs(b) <= 16:
                return a ** int(b)
            return a**b
        raise ValueError(op)
    if kind == "call":
        _, name, args = node
        fn = _FUNCTIONS.get(name)
        if fn is None:
            raise KeyError(f"unknown function {name!r}")
        return fn(*[_eval_node(a, env) for a in args])
    raise ValueError(node)


class CompiledExpression:
    """A Lepton expression compiled to a callable of a dict of variable
    values (numbers or tensors); broadcasting follows torch's rules, so
    per-pair tensors work directly."""

    def __init__(self, text: str):
        self.text = text
        statements = [s.strip() for s in text.split(";") if s.strip()]
        if not statements:
            raise ValueError("empty expression")
        self._main = _Parser(_tokenize(statements[0])).parse()
        self._defs: list[tuple[str, object]] = []
        for stmt in statements[1:]:
            if "=" not in stmt:
                raise ValueError(f"expected assignment: {stmt!r}")
            name, rhs = stmt.split("=", 1)
            self._defs.append((name.strip(), _Parser(_tokenize(rhs)).parse()))
        names = set()
        _collect_vars(self._main, names)
        for _, node in self._defs:
            _collect_vars(node, names)
        self.variables = names - {n for n, _ in self._defs} - set(_CONSTANTS)

    def __call__(self, env: Mapping[str, object]):
        scope = dict(env)
        # Lepton semantics: definitions may reference each other in any
        # textual order; resolve by repeated passes (dependency order)
        pending = list(self._defs)
        while pending:
            progressed = False
            still = []
            for name, node in pending:
                try:
                    scope[name] = _eval_node(node, scope)
                    progressed = True
                except KeyError:
                    still.append((name, node))
            if not progressed:
                missing = {n for n, _ in still}
                raise KeyError(f"unresolvable definitions {missing} in {self.text!r}")
            pending = still
        return _eval_node(self._main, scope)

    def __repr__(self):
        return f"CompiledExpression({self.text!r})"


def _collect_vars(node, out: set):
    kind = node[0]
    if kind == "var":
        out.add(node[1])
    elif kind == "neg":
        _collect_vars(node[1], out)
    elif kind == "binop":
        _collect_vars(node[2], out)
        _collect_vars(node[3], out)
    elif kind == "call":
        for a in node[2]:
            _collect_vars(a, out)


def compile_expression(text: str) -> CompiledExpression:
    return CompiledExpression(text)
