"""Query plans for the fused filter+project+sketch kernels.

A :class:`QueryPlan` is the static description the kernel templates compile
against: column predicates (conjunctive ``where``), a column projection,
and an optional group-by column.  Everything in the plan is baked into the
compiled kernel as constants -- the plan's :meth:`QueryPlan.key` is the
compile-cache key, so changing a predicate value recompiles while repeating
a plan hits the cache.

Predicate semantics are defined on the **float32 view** of the block (every
execution path -- numpy reference included -- evaluates predicates after an
``astype(float32)``), so a value that straddles the f32 rounding of the
threshold cannot flip between implementations.  Projections select columns
*after* filtering; ``group_by`` always indexes the original (pre-projection)
feature space, like ``RSPDataset.label_column`` does.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

OPS = ("lt", "le", "gt", "ge", "eq", "ne")
_NUMPY_OPS = {
    "lt": np.less,
    "le": np.less_equal,
    "gt": np.greater,
    "ge": np.greater_equal,
    "eq": np.equal,
    "ne": np.not_equal,
}
_SYMBOLS = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge", "==": "eq", "!=": "ne"}

_PRED_RE = re.compile(
    r"^\s*(?:c|col)?(\d+)\s*(<=|>=|==|!=|<|>)\s*([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\s*$"
)


@dataclasses.dataclass(frozen=True)
class Predicate:
    """One column comparison: ``column <op> value`` with ``op`` one of
    ``lt | le | gt | ge | eq | ne`` (symbols accepted and normalized)."""

    column: int
    op: str
    value: float

    def __post_init__(self):
        op = _SYMBOLS.get(self.op, self.op)
        if op not in OPS:
            raise ValueError(f"unknown predicate op {self.op!r} (one of {OPS} or symbols)")
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "column", int(self.column))
        object.__setattr__(self, "value", float(self.value))
        if self.column < 0:
            raise ValueError("predicate column must be >= 0")

    def mask(self, x: np.ndarray) -> np.ndarray:
        """Boolean row mask over ``x`` [n, F] (float32 comparison)."""
        return _NUMPY_OPS[self.op](x[:, self.column], np.float32(self.value))

    def __str__(self) -> str:
        sym = {v: k for k, v in _SYMBOLS.items()}[self.op]
        return f"c{self.column} {sym} {self.value:g}"


def parse_predicate(spec) -> Predicate:
    """``"c3 > 0.5"`` / ``"0 <= 1e-2"`` / ``(3, ">", 0.5)`` /
    ``Predicate`` -> :class:`Predicate`."""
    if isinstance(spec, Predicate):
        return spec
    if isinstance(spec, str):
        m = _PRED_RE.match(spec)
        if not m:
            raise ValueError(
                f"cannot parse predicate {spec!r} (expected e.g. 'c3 > 0.5')"
            )
        return Predicate(int(m.group(1)), m.group(2), float(m.group(3)))
    if isinstance(spec, (tuple, list)) and len(spec) == 3:
        return Predicate(int(spec[0]), str(spec[1]), float(spec[2]))
    raise TypeError(f"cannot build a Predicate from {type(spec).__name__}")


def as_predicates(where) -> tuple[Predicate, ...]:
    """Normalize a ``where=`` argument -- ``None``, one predicate spec, or a
    sequence of them -- into a tuple of :class:`Predicate` (AND semantics)."""
    if where is None:
        return ()
    if isinstance(where, (str, Predicate)):
        return (parse_predicate(where),)
    if isinstance(where, (tuple, list)):
        if len(where) == 3 and isinstance(where[0], (int, np.integer)):
            return (parse_predicate(where),)
        return tuple(parse_predicate(p) for p in where)
    raise TypeError(f"cannot build predicates from {type(where).__name__}")


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """The static shape of one fused block pass.

    ``predicates`` AND together (empty = all rows).  ``columns`` projects
    the sketch onto those original-space columns (``None`` = all).
    ``group_by``/``num_classes`` produce one sketch per class from the
    ``group_by`` column of the *original* feature space; ungrouped plans
    leave ``group_by=None`` and ``num_classes=1``.
    """

    predicates: tuple[Predicate, ...] = ()
    columns: tuple[int, ...] | None = None
    group_by: int | None = None
    num_classes: int = 1

    def __post_init__(self):
        object.__setattr__(self, "predicates", as_predicates(self.predicates))
        if self.columns is not None:
            object.__setattr__(
                self, "columns", tuple(int(c) for c in self.columns)
            )
            if len(self.columns) == 0:
                raise ValueError("columns= must name at least one column")
        if self.group_by is None:
            if self.num_classes != 1:
                raise ValueError("num_classes needs group_by (or must be 1)")
        elif self.num_classes < 1:
            raise ValueError("grouped plans need num_classes >= 1")

    @property
    def groups(self) -> int:
        return self.num_classes if self.group_by is not None else 1

    @property
    def filtered(self) -> bool:
        return bool(self.predicates)

    def key(self) -> tuple:
        """Hashable identity for the compile cache: two plans with the same
        key compile to the same kernel."""
        return (
            tuple((p.column, p.op, p.value) for p in self.predicates),
            self.columns,
            self.group_by,
            self.num_classes,
        )

    def resolve_columns(self, num_features: int) -> tuple[int, ...]:
        """The projected column indices against an ``[n, F]`` block."""
        if self.columns is None:
            return tuple(range(num_features))
        cols = tuple(c % num_features for c in self.columns)
        return cols

    def mask(self, x: np.ndarray) -> np.ndarray:
        """AND of all predicate masks over float32 ``x`` [n, F]."""
        if not self.predicates:
            return np.ones(x.shape[0], dtype=bool)
        m = self.predicates[0].mask(x)
        for p in self.predicates[1:]:
            m &= p.mask(x)
        return m
