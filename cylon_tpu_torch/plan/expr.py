"""Structured column expressions for the planner (counterpart of
cylon_tpu/plan/expr.py).

An optimizer must know which columns a predicate reads to push it below a
projection, a shuffle or one side of a join, so ``LazyFrame.filter`` takes
an ``Expr``: column refs, literals, comparisons, arithmetic and boolean
connectives, each knowing its column set, a structural key (for the plan
cache) and how to evaluate itself over one shard's dict of
:class:`~cylon_tpu_torch.column.Column`.

A row where any referenced column is null evaluates to null, and a filter
drops null rows. A string (dictionary-encoded) column compares against a
string literal through its sorted dictionary: code order is value order.
Mixed types take the JAX package's promotion, weak Python scalars included
(``compute.binary_op``).
"""
from __future__ import annotations

import operator
from typing import FrozenSet, Mapping, Optional, Tuple

import numpy as np
import torch

from ..column import Column
from ..compute import binary_op, bit_invert, promote

KeyCol = Tuple[torch.Tensor, Optional[torch.Tensor]]

_OPS = {
    "==": operator.eq, "!=": operator.ne, "<": operator.lt, "<=": operator.le,
    ">": operator.gt, ">=": operator.ge, "+": operator.add, "-": operator.sub,
    "*": operator.mul, "/": operator.truediv, "%": operator.mod,
    "&": operator.and_, "|": operator.or_,
}
#: the comparison a literal on the left becomes with the column on the left
_FLIP = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "==", "!=": "!="}


def _and_valid(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    if a is None:
        return b
    if b is None:
        return a
    return a & b


class Expr:
    """Base class; build via :func:`col` / :func:`lit` and operators."""

    def columns(self) -> FrozenSet[str]:
        raise NotImplementedError

    def rename(self, mapping: Mapping[str, str]) -> "Expr":
        """Substitute column names (used when pushing a filter through a
        projection rename or down one side of a join)."""
        raise NotImplementedError

    def key(self) -> tuple:
        """Structural fingerprint (feeds the plan-fingerprint cache)."""
        raise NotImplementedError

    def evaluate(self, cols: Mapping[str, Column]):
        """-> (data, valid | None) over one shard's rows; a literal's data
        is its Python value."""
        raise NotImplementedError

    # -- operator sugar ----------------------------------------------------
    def _bin(self, op: str, other) -> "BinOp":
        return BinOp(op, self, other if isinstance(other, Expr) else Lit(other))

    def __eq__(self, other):  # noqa: A003 — expression building, not identity
        return self._bin("==", other)

    def __ne__(self, other):
        return self._bin("!=", other)

    def __lt__(self, other):
        return self._bin("<", other)

    def __le__(self, other):
        return self._bin("<=", other)

    def __gt__(self, other):
        return self._bin(">", other)

    def __ge__(self, other):
        return self._bin(">=", other)

    def __add__(self, other):
        return self._bin("+", other)

    def __sub__(self, other):
        return self._bin("-", other)

    def __mul__(self, other):
        return self._bin("*", other)

    def __truediv__(self, other):
        return self._bin("/", other)

    def __mod__(self, other):
        return self._bin("%", other)

    def __and__(self, other):
        return self._bin("&", other)

    def __or__(self, other):
        return self._bin("|", other)

    def __invert__(self):
        return UnOp("~", self)

    def __neg__(self):
        return UnOp("-", self)

    def __hash__(self):
        return hash(self.key())


class Col(Expr):
    def __init__(self, name: str):
        self.name = name

    def columns(self) -> FrozenSet[str]:
        return frozenset({self.name})

    def rename(self, mapping) -> "Col":
        return Col(mapping.get(self.name, self.name))

    def key(self) -> tuple:
        return ("col", self.name)

    def evaluate(self, cols) -> KeyCol:
        c = cols[self.name]
        if c.dtype.is_dictionary:
            # codes only compare meaningfully against an encoded literal;
            # BinOp special-cases that pair before evaluating this side
            raise TypeError(
                f"string column {self.name!r} only supports comparison "
                "against a string literal in plan expressions"
            )
        return c.data, c.valid

    def __repr__(self):
        return f"col({self.name!r})"


class Lit(Expr):
    def __init__(self, value):
        if isinstance(value, Expr) or not isinstance(
            value, (int, float, bool, str, np.integer, np.floating, np.bool_)
        ):
            # fail at build time with a clear message — an unhashable value
            # would otherwise surface as a bare TypeError from the plan
            # fingerprint inside collect()
            raise TypeError(
                f"plan literals must be scalars (int/float/bool/str), "
                f"got {type(value).__name__}"
            )
        self.value = value

    def columns(self) -> FrozenSet[str]:
        return frozenset()

    def rename(self, mapping) -> "Lit":
        return self

    def key(self) -> tuple:
        return ("lit", type(self.value).__name__, self.value)

    def evaluate(self, cols):
        return self.value, None

    def __repr__(self):
        return repr(self.value)


_CMP = {"==", "!=", "<", "<=", ">", ">="}
_BOOL = {"&", "|"}


class BinOp(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        self.op = op
        self.left = left
        self.right = right

    def columns(self) -> FrozenSet[str]:
        return self.left.columns() | self.right.columns()

    def rename(self, mapping) -> "BinOp":
        return BinOp(self.op, self.left.rename(mapping), self.right.rename(mapping))

    def key(self) -> tuple:
        return ("bin", self.op, self.left.key(), self.right.key())

    def _dict_literal_cmp(self, c: Column, value, flip: bool) -> KeyCol:
        """Dictionary-encoded column vs string literal: compare codes
        against the literal's position bounds in the SORTED dictionary."""
        op = self.op
        if flip:  # lit <op> col  ==  col <flipped-op> lit
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
        d = c.dictionary
        lo = int(np.searchsorted(d, value, side="left"))
        hi = int(np.searchsorted(d, value, side="right"))
        code = c.data
        if op == "==":
            out = (code >= lo) & (code < hi)
        elif op == "!=":
            out = (code < lo) | (code >= hi)
        elif op == "<":
            out = code < lo
        elif op == "<=":
            out = code < hi
        elif op == ">":
            out = code >= hi
        else:  # ">="
            out = code >= lo
        return out, c.valid

    def evaluate(self, cols) -> KeyCol:
        if self.op in _CMP:
            # string-column comparisons route through the dictionary
            l, r = self.left, self.right
            if isinstance(l, Col) and isinstance(r, Lit):
                c = cols[l.name]
                if c.dtype.is_dictionary:
                    return self._dict_literal_cmp(c, r.value, flip=False)
            if isinstance(l, Lit) and isinstance(r, Col):
                c = cols[r.name]
                if c.dtype.is_dictionary:
                    return self._dict_literal_cmp(c, l.value, flip=True)
        if self.op not in _OPS:
            raise ValueError(f"unknown operator {self.op!r}")
        ld, lv = self.left.evaluate(cols)
        rd, rv = self.right.evaluate(cols)
        return _apply(self.op, ld, rd), _and_valid(lv, rv)

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


class UnOp(Expr):
    def __init__(self, op: str, operand: Expr):
        self.op = op
        self.operand = operand

    def columns(self) -> FrozenSet[str]:
        return self.operand.columns()

    def rename(self, mapping) -> "UnOp":
        return UnOp(self.op, self.operand.rename(mapping))

    def key(self) -> tuple:
        return ("un", self.op, self.operand.key())

    def evaluate(self, cols) -> KeyCol:
        d, v = self.operand.evaluate(cols)
        if not isinstance(d, torch.Tensor):
            d = torch.as_tensor(d)
        return (bit_invert(d) if self.op == "~" else torch.neg(d)), v

    def __repr__(self):
        return f"{self.op}{self.operand!r}"


def col(name: str) -> Col:
    """Reference a column by name in a plan expression."""
    return Col(name)


def lit(value) -> Lit:
    """Wrap a Python scalar as a plan-expression literal."""
    return Lit(value)


def _apply(op: str, a, b) -> torch.Tensor:
    """``a <op> b`` where either side may be a Python literal, in the JAX
    package's result type: a literal on the left of a comparison or a
    commutative operator swaps sides; otherwise it becomes a tensor of the
    promoted type."""
    fn = _OPS[op]
    if isinstance(a, torch.Tensor):
        return binary_op(fn, a, b)
    if isinstance(b, torch.Tensor):
        if op in _FLIP:
            return binary_op(_OPS[_FLIP[op]], b, a)
        if op in ("+", "*", "&", "|"):
            return binary_op(fn, b, a)
        return binary_op(fn, torch.full_like(b, a, dtype=promote(b.dtype, a)), b)
    return torch.as_tensor(fn(a, b))


def filter_mask(expr: Expr, cols: Mapping[str, Column]) -> torch.Tensor:
    """Evaluate a predicate to the boolean KEEP mask ``Table.filter`` takes:
    null predicate rows (any referenced column null) are dropped."""
    data, valid = expr.evaluate(cols)
    if not isinstance(data, torch.Tensor) or data.dtype != torch.bool:
        raise TypeError(f"filter predicate must be boolean, got {getattr(data, 'dtype', type(data))}")
    return data if valid is None else data & valid
