"""Order-property descriptors carried by Tables (counterpart of
cylon_tpu/ordering.py).

An op that provably establishes an order records an :class:`Ordering` on
its output; downstream ops read it to skip their own sorts: a groupby
run-detects instead of lexsorting, a join skips the right side's sort, the
set ops and ``unique`` run-detect, a sort elides itself or sorts only the
key suffix. The planner's ``order_reuse`` rule reads the same property of
plan nodes.

``Ordering(keys, ascending, nulls_last, scope, canonical, lexsort_exact)``
asserts that every shard's rows are ordered by ``keys`` (major first) with
the given directions:

- ``scope``: ``"shard"``, each shard's rows are ordered; ``"global"``, in
  addition shard i's rows all precede shard i+1's (``distributed_sort``);
- ``canonical``: ordered by the canonical key lanes of
  ``ops.sort.canonical_row_lanes`` (ascending orderable lanes, nulls last
  per key with a zeroed value lane): the order factorize, groupby and the
  set ops emit, and the one run detection needs when keys hold nulls;
- ``lexsort_exact``: ``Table.sort`` with exactly this spec is the identity.

Constructors attach no ordering unless a call site does, so a forgotten
propagation costs a fast path, never a wrong answer. :func:`disabled` turns
every consumer off for the block (the differential oracle); the planner
keys its cache by :func:`enabled`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

from .utils.envgate import env_gate


class Ordering(NamedTuple):
    """Validated sortedness descriptor (see module docstring)."""

    keys: Tuple[str, ...]
    ascending: Tuple[bool, ...]
    nulls_last: bool = True
    scope: str = "shard"
    canonical: bool = False
    lexsort_exact: bool = False

    def describe(self) -> str:
        """Compact one-line rendering for ``.explain()`` / repr."""
        ks = ", ".join(
            f"{k} {'asc' if a else 'desc'}"
            for k, a in zip(self.keys, self.ascending)
        )
        return f"[{ks}] @{self.scope}"


def validate(ordering: Optional[Ordering], column_names) -> Optional[Ordering]:
    """Check a descriptor against a table's columns; raises on malformed
    descriptors, returns the descriptor (or None) otherwise."""
    if ordering is None:
        return None
    if not isinstance(ordering, Ordering):
        raise TypeError(f"ordering must be an Ordering, got {type(ordering)}")
    if not ordering.keys:
        raise ValueError("ordering needs at least one key column")
    if len(ordering.keys) != len(ordering.ascending):
        raise ValueError("ordering keys/ascending length mismatch")
    if ordering.scope not in ("shard", "global"):
        raise ValueError(f"unknown ordering scope {ordering.scope!r}")
    missing = [k for k in ordering.keys if k not in column_names]
    if missing:
        raise ValueError(f"ordering keys not in table: {missing}")
    if ordering.canonical and (
        not all(ordering.ascending) or not ordering.nulls_last
    ):
        raise ValueError(
            "canonical orderings are ascending + nulls-last by definition"
        )
    return ordering


# the CYLON_TPU_TORCH_NO_ORDERING=1 kill switch: ``enabled()`` is False
# inside ``disabled()`` (or with the variable set), and every descriptor
# consumer then takes the path it takes on an unordered input (the
# differential oracle); the planner keys its cache by the gate
enabled, disabled = env_gate(
    "CYLON_TPU_TORCH_NO_ORDERING",
    keyed_via="the plan fingerprint carries the gate (plan/lazy.py)",
)


def covers_prefix(
    ordering: Optional[Ordering],
    names: Sequence[str],
    need_canonical: bool = True,
) -> bool:
    """Does the descriptor prove the rows ordered by ``names`` (major first,
    all ascending, nulls last)?

    ``need_canonical=True`` additionally demands the canonical null
    discipline — required whenever the consumer run-detects or compares key
    runs on columns that may carry validity masks (see module docstring);
    callers that verified every involved column is mask-free may relax it.
    """
    if ordering is None or not enabled():
        return False
    k = len(names)
    if k == 0 or len(ordering.keys) < k:
        return False
    if tuple(ordering.keys[:k]) != tuple(names):
        return False
    if not all(ordering.ascending[:k]):
        return False
    if not ordering.nulls_last:
        return False
    if need_canonical and not ordering.canonical:
        return False
    return True


def matches_sort_spec(
    ordering: Optional[Ordering],
    names: Sequence[str],
    ascending: Sequence[bool],
    nulls_last: bool = True,
) -> int:
    """Length of the longest prefix of the requested sort spec the
    descriptor already guarantees AS THE LEXSORT WOULD PRODUCE IT
    (``lexsort_exact`` — identity-safe). 0 = no reuse; ``len(names)`` =
    the whole sort is a no-op."""
    if ordering is None or not enabled() or not ordering.lexsort_exact:
        return 0
    if ordering.nulls_last != nulls_last:
        return 0
    m = 0
    for i, (n, a) in enumerate(zip(names, ascending)):
        if i >= len(ordering.keys):
            break
        if ordering.keys[i] != n or ordering.ascending[i] != bool(a):
            break
        m += 1
    return m


def rename(
    ordering: Optional[Ordering], mapping: dict
) -> Optional[Ordering]:
    """Ordering after a column rename (descriptor follows its columns)."""
    if ordering is None:
        return None
    return ordering._replace(
        keys=tuple(mapping.get(k, k) for k in ordering.keys)
    )


def truncate_to(
    ordering: Optional[Ordering], kept_names
) -> Optional[Ordering]:
    """Ordering after a projection: the longest key prefix whose columns
    all survive (rows stay sorted by any prefix of the original keys)."""
    if ordering is None:
        return None
    kept = set(kept_names)
    m = 0
    for k in ordering.keys:
        if k not in kept:
            break
        m += 1
    if m == 0:
        return None
    return ordering._replace(
        keys=ordering.keys[:m], ascending=ordering.ascending[:m]
    )
