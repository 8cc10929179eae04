"""Data type system of the PyTorch port (counterpart of cylon_tpu/dtypes.py).

The logical type enum is the JAX package's, value for value, so an encoding
made by either package (``Column.encode_host``) reads in the other. Every
logical type maps onto a physical numpy dtype; on the device a column is a
torch tensor of the matching torch dtype. STRING / BINARY are dictionary
encoded: int32 codes on the device plus a sorted host-side numpy dictionary.
"""
from __future__ import annotations

import enum

import numpy as np
import torch


class Type(enum.IntEnum):
    """Logical types (reference data_types.hpp:25-64)."""

    BOOL = 0
    UINT8 = 1
    INT8 = 2
    UINT16 = 3
    INT16 = 4
    UINT32 = 5
    INT32 = 6
    UINT64 = 7
    INT64 = 8
    HALF_FLOAT = 9
    FLOAT = 10
    DOUBLE = 11
    STRING = 12
    BINARY = 13
    FIXED_SIZE_BINARY = 14
    DATE32 = 16
    DATE64 = 17
    TIMESTAMP = 18
    TIME32 = 19
    TIME64 = 20
    INTERVAL = 21
    DECIMAL = 22
    LIST = 23
    EXTENSION = 24
    FIXED_SIZE_LIST = 25
    DURATION = 26


_NUMPY_TO_TYPE = {
    np.dtype(np.bool_): Type.BOOL,
    np.dtype(np.uint8): Type.UINT8,
    np.dtype(np.int8): Type.INT8,
    np.dtype(np.uint16): Type.UINT16,
    np.dtype(np.int16): Type.INT16,
    np.dtype(np.uint32): Type.UINT32,
    np.dtype(np.int32): Type.INT32,
    np.dtype(np.uint64): Type.UINT64,
    np.dtype(np.int64): Type.INT64,
    np.dtype(np.float16): Type.HALF_FLOAT,
    np.dtype(np.float32): Type.FLOAT,
    np.dtype(np.float64): Type.DOUBLE,
}

_TYPE_TO_NUMPY = {v: k for k, v in _NUMPY_TO_TYPE.items()}
_TYPE_TO_NUMPY[Type.STRING] = np.dtype(np.int32)
_TYPE_TO_NUMPY[Type.BINARY] = np.dtype(np.int32)
_TYPE_TO_NUMPY[Type.DATE32] = np.dtype(np.int32)
_TYPE_TO_NUMPY[Type.DATE64] = np.dtype(np.int64)
_TYPE_TO_NUMPY[Type.TIMESTAMP] = np.dtype(np.int64)
_TYPE_TO_NUMPY[Type.TIME32] = np.dtype(np.int32)
_TYPE_TO_NUMPY[Type.TIME64] = np.dtype(np.int64)
_TYPE_TO_NUMPY[Type.DURATION] = np.dtype(np.int64)

UNSUPPORTED_TYPES = frozenset(
    {
        Type.FIXED_SIZE_BINARY,
        Type.INTERVAL,
        Type.DECIMAL,
        Type.LIST,
        Type.EXTENSION,
        Type.FIXED_SIZE_LIST,
    }
)

_NUMPY_TO_TORCH = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_TORCH_TO_NUMPY = {v: k for k, v in _NUMPY_TO_TORCH.items()}


class UnsupportedTypeError(TypeError):
    """Raised for enum-tail types with no physical representation."""


def torch_dtype(np_dtype) -> torch.dtype:
    return _NUMPY_TO_TORCH[np.dtype(np_dtype)]


def numpy_dtype(dt: torch.dtype) -> np.dtype:
    return _TORCH_TO_NUMPY[dt]


class DataType:
    """A logical column type; ``physical_dtype`` is the numpy dtype of the
    device buffer (int32 codes for dictionary types)."""

    __slots__ = ("type",)

    def __init__(self, type_: Type):
        self.type = Type(int(type_))

    @property
    def is_dictionary(self) -> bool:
        return self.type in (Type.STRING, Type.BINARY)

    @property
    def physical_dtype(self) -> np.dtype:
        if self.type in UNSUPPORTED_TYPES:
            raise UnsupportedTypeError(
                f"{self.type.name} has no physical representation; cast to a "
                "supported type"
            )
        return _TYPE_TO_NUMPY[self.type]

    @classmethod
    def from_numpy_dtype(cls, dt) -> "DataType":
        dt = np.dtype(dt)
        if dt.kind in ("U", "S", "O"):
            return cls(Type.STRING)
        if dt.kind == "M":
            return cls(Type.TIMESTAMP)
        if dt.kind == "m":
            return cls(Type.DURATION)
        t = _NUMPY_TO_TYPE.get(dt)
        if t is None:
            raise TypeError(f"unsupported dtype {dt}")
        return cls(t)

    @classmethod
    def of(cls, dt) -> "DataType":
        """This package's DataType for any object carrying a logical type
        (``.type``), e.g. the JAX package's DataType, or a bare enum value."""
        if isinstance(dt, DataType):
            return dt
        return cls(int(getattr(dt, "type", dt)))

    def __eq__(self, other):
        return isinstance(other, DataType) and self.type == other.type

    def __hash__(self):
        return hash(self.type)

    def __repr__(self):
        return f"DataType({self.type.name})"


def promote_key_dtypes(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """Common dtype for cross-dtype key comparison, by NUMPY promotion rules
    (int32 x uint32 -> int64, int64 x float32 -> float64): torch's own rules
    would narrow some pairs and wrap values."""
    common = np.promote_types(numpy_dtype(a), numpy_dtype(b))
    return torch_dtype(common)


def promote_concat_dtypes(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """Common dtype of two columns stacked by a concat, by the JAX package's
    promotion lattice (``jnp.promote_types`` with 64-bit types on), which
    differs from numpy's: an integer with a float takes the float's width
    (int32 with float32 is float32), float16 with bfloat16 is float32, and
    uint64 with any signed integer is float64."""
    if a == b or b == torch.bool:
        return a
    if a == torch.bool:
        return b
    fa, fb = a.is_floating_point, b.is_floating_point
    if fa and fb:
        if {a, b} == {torch.float16, torch.bfloat16}:
            return torch.float32
        return a if a.itemsize > b.itemsize else b
    if fa or fb:
        return a if fa else b
    if a.is_signed == b.is_signed:
        return a if a.itemsize > b.itemsize else b
    u, s = (b, a) if a.is_signed else (a, b)
    if u == torch.uint64:
        return torch.float64
    if s.itemsize > u.itemsize:
        return s
    return {1: torch.int16, 2: torch.int32, 4: torch.int64}[u.itemsize]
