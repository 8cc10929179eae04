"""Join configuration object (counterpart of cylon_tpu/join_config.py).

Reference analog: ``cylon::join::config::JoinConfig``
(cpp/src/cylon/join/join_config.hpp:26-189): JoinType {INNER, LEFT, RIGHT,
FULL_OUTER}, JoinAlgorithm {SORT, HASH}, single or multi key columns,
column suffixes, and the static builders InnerJoin / LeftJoin / RightJoin /
FullOuterJoin. ``Table.join(other, config=cfg)`` takes it in place of the
explicit join arguments.

SORT and HASH both run the sort join. PALLAS_PK keeps the JAX package's
name and selects the bucketed PK-FK probe (ops/pk_join.py), which runs
kernel B5 on the card."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union


class JoinAlgorithm:
    SORT = "sort"
    HASH = "hash"
    # the bucketed PK-FK probe; speculative: falls back to SORT on duplicate
    # right keys or bucket overflow
    PALLAS_PK = "pallas_pk"


class JoinConfig:
    def __init__(
        self,
        join_type: str,
        on: Optional[Union[str, Sequence[str]]] = None,
        left_on: Optional[Sequence[str]] = None,
        right_on: Optional[Sequence[str]] = None,
        algorithm: str = JoinAlgorithm.SORT,
        suffixes: Tuple[str, str] = ("_x", "_y"),
    ):
        from .ops.join import join_type_id

        join_type_id(join_type)  # validate early
        if algorithm not in (
            JoinAlgorithm.SORT, JoinAlgorithm.HASH, JoinAlgorithm.PALLAS_PK
        ):
            raise ValueError(f"unknown join algorithm {algorithm!r}")
        self.join_type = join_type
        self.on = on
        self.left_on = left_on
        self.right_on = right_on
        self.algorithm = algorithm
        self.suffixes = tuple(suffixes)

    # static builders (reference join_config.hpp:58-80)
    @classmethod
    def inner_join(cls, **kw) -> "JoinConfig":
        return cls("inner", **kw)

    @classmethod
    def left_join(cls, **kw) -> "JoinConfig":
        return cls("left", **kw)

    @classmethod
    def right_join(cls, **kw) -> "JoinConfig":
        return cls("right", **kw)

    @classmethod
    def full_outer_join(cls, **kw) -> "JoinConfig":
        return cls("outer", **kw)

    def kwargs(self) -> dict:
        """Expand into Table.join keyword arguments."""
        kw = dict(
            how=self.join_type,
            suffixes=self.suffixes,
            algorithm=self.algorithm,
        )
        if self.on is not None:
            kw["on"] = self.on
        if self.left_on is not None:
            kw["left_on"] = self.left_on
        if self.right_on is not None:
            kw["right_on"] = self.right_on
        return kw

    def __repr__(self):
        keys = self.on if self.on is not None else (self.left_on, self.right_on)
        return (
            f"JoinConfig({self.join_type}, keys={keys!r}, "
            f"algorithm={self.algorithm})"
        )
