"""Column: a typed, nullable device-resident column (counterpart of
cylon_tpu/column.py).

The physical storage is an exact-length torch tensor (no padding rows), an
optional bool validity tensor, and, for dictionary-encoded types, a host-side
SORTED numpy dictionary so that code order == value order.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .dtypes import DataType, Type


class Column:
    __slots__ = ("data", "valid", "dtype", "dictionary")

    def __init__(
        self,
        data: torch.Tensor,
        dtype: DataType,
        valid: Optional[torch.Tensor] = None,
        dictionary: Optional[np.ndarray] = None,
    ):
        self.data = data
        self.dtype = dtype
        self.valid = valid  # None == all rows valid
        self.dictionary = dictionary
        if dtype.is_dictionary and dictionary is None:
            raise ValueError("dictionary-encoded column requires a dictionary")

    @staticmethod
    def encode_host(
        values: np.ndarray,
    ) -> tuple[np.ndarray, Optional[np.ndarray], DataType, Optional[np.ndarray]]:
        """Host-side: raw numpy values -> (physical data, valid, dtype, dict).

        The same encoding as the JAX package's ``Column.encode_host``:
        strings/objects are dictionary-encoded against a sorted dictionary
        (np.unique), all-numeric object columns stay numeric, NaN / None /
        NaT become nulls."""
        values = np.asarray(values)
        if values.dtype.kind in ("U", "S", "O"):
            vals = np.asarray(values, dtype=object)
            is_null = np.array(
                [v is None or (isinstance(v, float) and np.isnan(v)) for v in vals],
                dtype=bool,
            )
            if values.dtype.kind == "O":
                live = [v for v, nul in zip(vals, is_null) if not nul]
                if live and all(
                    isinstance(v, (int, float, np.integer, np.floating, bool, np.bool_))
                    for v in live
                ):
                    if all(isinstance(v, (bool, np.bool_)) for v in live):
                        num = np.where(is_null, False, vals).astype(bool)
                        return Column.encode_host(num) if not is_null.any() else (
                            num, ~is_null, DataType.from_numpy_dtype(np.dtype(bool)), None
                        )
                    if all(
                        isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))
                        for v in live
                    ):
                        try:
                            num = np.where(is_null, 0, vals).astype(np.int64)
                        except OverflowError:
                            num = None
                        if num is not None:
                            if not is_null.any():
                                return Column.encode_host(num)
                            return (
                                num, ~is_null,
                                DataType.from_numpy_dtype(np.dtype(np.int64)), None,
                            )
                    else:
                        num = np.full(len(vals), np.nan, np.float64)
                        num[~is_null] = [float(v) for v in live]
                        return Column.encode_host(num)
            vals = np.asarray(
                [
                    ("true" if v is True else "false" if v is False else v)
                    if isinstance(v, (bool, np.bool_))
                    else v
                    for v in vals
                ],
                dtype=object,
            )
            safe = np.where(is_null, "", vals)
            dictionary, codes = np.unique(np.asarray(safe, dtype=str), return_inverse=True)
            codes = codes.astype(np.int32)
            valid = None if not is_null.any() else ~is_null
            return codes, valid, DataType(Type.STRING), dictionary
        if values.dtype.kind == "M":
            data = values.astype("datetime64[ns]").astype(np.int64)
            is_null = np.isnat(values)
            valid = None if not is_null.any() else ~is_null
            return data, valid, DataType(Type.TIMESTAMP), None
        if values.dtype.kind == "m":
            data = values.astype("timedelta64[ns]").astype(np.int64)
            is_null = np.isnat(values)
            valid = None if not is_null.any() else ~is_null
            return data, valid, DataType(Type.DURATION), None
        if values.dtype.kind == "f":
            is_null = np.isnan(values)
            valid = None if not is_null.any() else ~is_null
            return values, valid, DataType.from_numpy_dtype(values.dtype), None
        return values, None, DataType.from_numpy_dtype(values.dtype), None

    @property
    def length(self) -> int:
        return self.data.shape[0]

    def valid_mask(self) -> torch.Tensor:
        """The validity mask, all True when the column has none."""
        if self.valid is None:
            return torch.ones(self.data.shape, dtype=torch.bool, device=self.data.device)
        return self.valid

    def decode_host(self, data_np: np.ndarray, valid_np: Optional[np.ndarray]):
        """Physical host values -> logical numpy values (strings decoded,
        nulls as NaN/None)."""
        if self.dtype.is_dictionary:
            out = self.dictionary[np.clip(data_np, 0, len(self.dictionary) - 1)]
            out = out.astype(object)
            if valid_np is not None:
                out[~valid_np] = None
            return out
        if self.dtype.type == Type.TIMESTAMP:
            out = data_np.astype("datetime64[ns]")
            if valid_np is not None:
                out[~valid_np] = np.datetime64("NaT")
            return out
        if self.dtype.type == Type.DURATION:
            out = data_np.astype("timedelta64[ns]")
            if valid_np is not None:
                out[~valid_np] = np.timedelta64("NaT")
            return out
        if valid_np is not None and not valid_np.all():
            if self.dtype.type == Type.BOOL:
                out = data_np.astype(bool).astype(object)
                out[~valid_np] = None
                return out
            out = data_np.astype(np.float64, copy=True)
            out[~valid_np] = np.nan
            return out
        return data_np

    def __repr__(self):
        return (
            f"Column({self.dtype}, n={self.length}, "
            f"nullable={self.valid is not None}, device={self.data.device})"
        )


def unify_dictionaries(a: Column, b: Column) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Union dictionary of two dictionary columns plus the old-code ->
    new-code remapping vectors (host side, numpy). The union is sorted, so
    code order stays value order."""
    union = np.union1d(a.dictionary, b.dictionary)
    map_a = np.searchsorted(union, a.dictionary).astype(np.int32)
    map_b = np.searchsorted(union, b.dictionary).astype(np.int32)
    return union, map_a, map_b
