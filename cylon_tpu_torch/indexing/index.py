"""Index objects for pandas-style row addressing (counterpart of
cylon_tpu/indexing/index.py; the reference's indexing/index.hpp).

A table's index is either a :class:`RangeIndex` (the global row number,
no storage) or a :class:`ColumnIndex` (one of its columns). Label
lookups probe a sorted view of the index column on its device
(:class:`HashIndex`; :class:`LinearIndex` adds the reference's KeyError).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..dtypes import numpy_dtype
from ..ops.sort import _sortable, lexsort_indices, orderable_key


class BaseIndex:
    """Common index surface (reference indexing/index.hpp:30-80)."""

    @property
    def name(self) -> Optional[str]:
        raise NotImplementedError

    def is_range(self) -> bool:
        return False


class RangeIndex(BaseIndex):
    """The implicit positional index: rows 0..n-1 in table order."""

    def __init__(self, size: int):
        self._size = int(size)

    @property
    def name(self):
        return None

    @property
    def size(self) -> int:
        return self._size

    def is_range(self) -> bool:
        return True

    def __repr__(self):
        return f"RangeIndex(0..{self._size})"


class ColumnIndex(BaseIndex):
    """An index held by a column of the table."""

    def __init__(self, column_name: str):
        self._name = column_name

    @property
    def name(self) -> str:
        return self._name

    def __repr__(self):
        return f"ColumnIndex({self._name!r})"


def encode_lookup_values(dictionary: Optional[np.ndarray], phys_dtype, values) -> np.ndarray:
    """Host lookup values -> values comparable with the index column's
    physical data. A string missing from a dictionary encodes to -1 (no
    code), a float index's unrepresentable value to NaN (matches nothing);
    an integer index refuses an unrepresentable value (3.5) with KeyError,
    as pandas does, rather than alias it to 3."""
    vals = np.asarray(values)
    if dictionary is not None:
        pos = np.clip(np.searchsorted(dictionary, vals), 0, max(len(dictionary) - 1, 0))
        hit = dictionary[pos] == vals if len(dictionary) else np.zeros(len(vals), bool)
        return np.where(hit, pos, -1).astype(np.int32)
    try:
        enc = vals.astype(phys_dtype)
        bad = enc.astype(np.float64) != np.asarray(vals, np.float64)
    except (ValueError, TypeError):
        raise KeyError(
            f"lookup values not comparable to index dtype {np.dtype(phys_dtype)}: "
            f"{np.asarray(values).tolist()[:5]}"
        ) from None
    if bad.any():
        if np.issubdtype(np.dtype(phys_dtype), np.floating):
            enc = np.where(bad, np.asarray(np.nan, phys_dtype), enc)
        else:
            raise KeyError(
                f"lookup values not representable in index dtype {np.dtype(phys_dtype)}: "
                f"{vals[bad][:5].tolist()}"
            )
    return enc


class HashIndex(BaseIndex):
    """A build-once value -> row positions lookup over the index column
    (the reference's HashIndex multimap): a sorted view of the column on its
    device, the stable K1 argsort of its lane and the row positions in that
    order, probed by binary search. Null entries are left out: no value
    looks them up. ``loc`` with a list of labels probes one of these, kept
    by ``Table.build_index`` or made for the call."""

    def __init__(self, table, column_name: Optional[str] = None):
        name = column_name or table.index_name
        if name is None:
            raise ValueError(f"{type(self).__name__} requires an index column")
        self._name = name
        col = table.column(name)  # the whole column on this process's device
        self._dictionary = col.dictionary if col.dtype.is_dictionary else None
        self._phys_dtype = numpy_dtype(col.data.dtype)
        self._rows = col.data.shape[0]
        data = col.data
        positions = torch.arange(data.shape[0], dtype=torch.int64, device=data.device)
        if col.valid is not None:
            data, positions = data[col.valid], positions[col.valid]
        lane = orderable_key(data)
        perm = lexsort_indices([lane], data.shape[0]).to(torch.int64)
        self._sorted = _sortable(lane.index_select(0, perm))
        self._positions = positions.index_select(0, perm)

    @property
    def name(self) -> str:
        return self._name

    def _encode(self, values) -> np.ndarray:
        return encode_lookup_values(self._dictionary, self._phys_dtype, values)

    def _runs(self, values):
        """Per label, the start and length of its run in the sorted view."""
        enc = np.ascontiguousarray(self._encode(values))
        probe = _sortable(orderable_key(torch.from_numpy(enc).to(self._sorted.device)))
        lo = torch.searchsorted(self._sorted, probe)
        return lo, torch.searchsorted(self._sorted, probe, right=True) - lo

    def _expand(self, lo, cnt) -> np.ndarray:
        """The positions of every run in label order (stable sort: each
        run is in index order)."""
        total = int(cnt.sum().item())
        if total == 0:
            return np.empty(0, np.int64)
        dev = cnt.device
        label = torch.repeat_interleave(torch.arange(cnt.shape[0], device=dev), cnt)
        start = torch.cumsum(cnt, 0) - cnt
        off = torch.arange(total, dtype=torch.int64, device=dev) - start.index_select(0, label)
        return self._positions.index_select(0, lo.index_select(0, label) + off).cpu().numpy()

    def get_loc(self, value) -> np.ndarray:
        """Every row position holding ``value``, ascending."""
        return self._expand(*self._runs([value]))

    def loc_positions(self, values) -> np.ndarray:
        """Row positions of a batch of labels in request order, each
        label's rows in index order (a repeated index value repeats its
        rows, a repeated label its matches); missing labels are skipped."""
        return self._expand(*self._runs(values))

    def __contains__(self, value) -> bool:
        try:
            return bool(self._runs([value])[1][0].item() > 0)
        except KeyError:
            return False

    def __repr__(self):
        return f"HashIndex({self._name!r}, n={self._sorted.shape[0]})"


class LinearIndex(HashIndex):
    """The reference's LinearIndex: HashIndex's lookup, except that a list
    lookup raises KeyError for a missing label."""

    def loc_positions(self, values) -> np.ndarray:
        lo, cnt = self._runs(values)
        missing = torch.nonzero(cnt == 0).flatten()
        if missing.numel():
            v = np.asarray(values)[int(missing[0].item())]
            raise KeyError(f"index value not found: {v!r}")
        return self._expand(lo, cnt)

    def __repr__(self):
        return f"LinearIndex({self._name!r}, n={self._rows})"


# the Python-facing index classes of pycylon (python/pycylon/index.py),
# holding host index values


class Index:
    def __init__(self, data=None):
        self._values = None if data is None else np.asarray(data)

    @property
    def index(self):
        return self._values

    @property
    def index_values(self):
        return self._values

    def __len__(self):
        return 0 if self._values is None else len(self._values)

    def __repr__(self):
        return f"{type(self).__name__}({self._values!r})"


class NumericIndex(Index):
    def __init__(self, data=None):
        super().__init__(data)
        if self._values is not None and self._values.dtype.kind not in "iuf":
            raise ValueError("NumericIndex requires numeric values")


class IntegerIndex(NumericIndex):
    def __init__(self, data=None):
        super().__init__(data)
        if self._values is not None and self._values.dtype.kind not in "iu":
            raise ValueError("IntegerIndex requires integer values")


class PyRangeIndex(IntegerIndex):
    """A start/stop/step range (pycylon's RangeIndex), named apart from the
    table's positional :class:`RangeIndex`."""

    def __init__(self, data=None, start: int = 0, stop: int = 0, step: int = 1):
        if data is not None:
            raw = np.asarray(data)
            if len(raw) and raw.dtype.kind not in "iu":
                raise ValueError("PyRangeIndex data must be integers")
            r = raw.astype(np.int64)
            step_ = int(r[1] - r[0]) if len(r) >= 2 else 1
            if step_ == 0 or (len(r) >= 2 and (np.diff(r) != step_).any()):
                raise ValueError("PyRangeIndex data must be an arithmetic range")
            super().__init__(r)
            self.start = int(r[0]) if len(r) else 0
            self.step = step_
            self.stop = self.start + step_ * len(r)
        else:
            step = step or 1
            super().__init__(np.arange(start, stop, step, dtype=np.int64))
            self.start, self.stop, self.step = start, stop, step


class CategoricalIndex(Index):
    def __init__(self, data=None):
        super().__init__(None if data is None else np.asarray(data, dtype=object))
