"""Row filters over numpy columns, as pandas' ``DataFrame.eval`` reads them.

Counterpart of ``gordo_components_tpu/dataset/filter_rows.py``. A config's
``row_filter`` is a pandas expression such as
``"`TAG-1` > 0 & `TAG-2` < 100"``. It is checked against the JAX package's
allowlist of syntax (no attribute access, no call but ``abs``, no
subscripts) and then evaluated by walking its syntax tree over the
columns; nothing is ever passed to ``eval``.

pandas gives ``&`` and ``|`` the precedence of ``and`` and ``or``, below
the comparisons, where Python binds them tighter: it rewrites them to
``and`` and ``or`` before it parses, and so does this module. So
``a > 1 & b < 30`` is ``(a > 1) & (b < 30)``, and ``a > 3 | b < 30 & a > 1``
keeps ``and`` over ``or``. ``not`` and ``~`` negate, comparisons chain
(``1 < a < 4``), ``==`` and ``!=`` against a list test membership, and
``+ - * / % **`` and ``abs()`` compute as numpy does on the columns.
"""

import ast
import logging
import operator
import re
from typing import Dict, Mapping

import numpy as np

logger = logging.getLogger(__name__)

_ALLOWED_NODES = (
    ast.Expression,
    ast.BoolOp, ast.And, ast.Or,
    ast.UnaryOp, ast.Not, ast.USub, ast.UAdd, ast.Invert,
    ast.BinOp, ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.Pow,
    ast.BitAnd, ast.BitOr,
    ast.Compare, ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.Name, ast.Load, ast.Constant, ast.Tuple, ast.List, ast.Call,
)
_ALLOWED_CALLS = {"abs"}
_BINOPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
           ast.Div: operator.truediv, ast.Mod: operator.mod, ast.Pow: operator.pow}
_COMPARE = {ast.Eq: operator.eq, ast.NotEq: operator.ne, ast.Lt: operator.lt,
            ast.LtE: operator.le, ast.Gt: operator.gt, ast.GtE: operator.ge}


def _booleans(expr: str) -> str:
    return expr.replace("&", " and ").replace("|", " or ")


def _check_expression(expr: str) -> None:
    """The JAX package's check: backtick names stand in as one identifier,
    ``&``/``|`` as ``and``/``or``; every node must be on the allowlist."""
    cleaned = _booleans(re.sub(r"`[^`]*`", "_col_", expr))
    try:
        tree = ast.parse(cleaned, mode="eval")
    except SyntaxError as exc:
        raise ValueError(f"Cannot parse row_filter expression {expr!r}: {exc}")
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(f"Disallowed construct {type(node).__name__} in row_filter {expr!r}")
        if isinstance(node, ast.Call):
            if not (isinstance(node.func, ast.Name) and node.func.id in _ALLOWED_CALLS):
                raise ValueError(f"Disallowed call in row_filter {expr!r}")


def _parse(expr: str):
    """The expression's tree, each backtick name replaced by an identifier
    the expression does not use; (tree, identifier -> column name)."""
    names: Dict[str, str] = {}

    def swap(m):
        for ident, name in names.items():
            if name == m.group(1):
                return f" {ident} "
        ident = f"_bt{len(names)}_"
        while ident in expr:
            ident = "_" + ident
        names[ident] = m.group(1)
        return f" {ident} "

    return ast.parse(_booleans(re.sub(r"`([^`]*)`", swap, expr)).strip(), mode="eval"), names


class _Evaluator:
    def __init__(self, columns: Mapping[str, np.ndarray], aliases: Dict[str, str], expr: str):
        self.columns, self.aliases, self.expr = columns, aliases, expr

    def __call__(self, node):
        if isinstance(node, ast.Expression):
            return self(node.body)
        if isinstance(node, ast.Name):
            name = self.aliases.get(node.id, node.id)
            if name not in self.columns:
                raise ValueError(f"row_filter {self.expr!r} names {name!r}, which is no column")
            return self.columns[name]
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, (ast.List, ast.Tuple)):
            return [self(e) for e in node.elts]
        if isinstance(node, ast.BoolOp):
            combine = np.logical_and if isinstance(node.op, ast.And) else np.logical_or
            out = self(node.values[0])
            for value in node.values[1:]:
                out = combine(out, self(value))
            return out
        if isinstance(node, ast.UnaryOp):
            operand = self(node.operand)
            if isinstance(node.op, (ast.Not, ast.Invert)):
                return ~np.asarray(operand)
            return -operand if isinstance(node.op, ast.USub) else +operand
        if isinstance(node, ast.BinOp):
            return _BINOPS[type(node.op)](self(node.left), self(node.right))
        if isinstance(node, ast.Compare):
            out, left = None, self(node.left)
            for op, comparator in zip(node.ops, node.comparators):
                right = self(comparator)
                pair = self._compare(op, left, right)
                out = pair if out is None else np.logical_and(out, pair)
                left = right
            return out
        if isinstance(node, ast.Call):
            (arg,) = node.args
            return np.abs(self(arg))
        raise ValueError(f"Disallowed construct {type(node).__name__} in row_filter {self.expr!r}")

    @staticmethod
    def _compare(op, left, right):
        if isinstance(right, list) and isinstance(op, (ast.Eq, ast.NotEq)):
            inside = np.isin(left, right)  # pandas reads == [..] as isin
            return inside if isinstance(op, ast.Eq) else ~inside
        return _COMPARE[type(op)](left, right)


def filter_mask(columns: Mapping[str, np.ndarray], filter_str: str, n_rows: int) -> np.ndarray:
    """The boolean row mask of ``filter_str`` over ``columns`` (name ->
    values, ``n_rows`` each); all True for an empty filter."""
    if not isinstance(filter_str, str) or not filter_str.strip():
        return np.ones(n_rows, bool)
    _check_expression(filter_str)
    tree, aliases = _parse(filter_str)
    with np.errstate(all="ignore"):  # inf and NaN compute as in pandas, quietly
        mask = np.asarray(_Evaluator(columns, aliases, filter_str)(tree))
    if mask.dtype != bool or mask.shape != (n_rows,):
        raise ValueError(f"row_filter {filter_str!r} gives {mask.dtype} of shape {mask.shape}, "
                         f"not one boolean a row")
    logger.info("row_filter %r kept %d/%d rows", filter_str, int(mask.sum()), n_rows)
    return mask
