"""Row addressing by index values (``loc``) and by global row number
(``iloc``): the counterpart of cylon_tpu/indexing/."""
from .index import (  # noqa: F401
    BaseIndex,
    CategoricalIndex,
    ColumnIndex,
    HashIndex,
    Index,
    IntegerIndex,
    LinearIndex,
    NumericIndex,
    PyRangeIndex,
    RangeIndex,
    encode_lookup_values,
)
from .indexer import ILocIndexer, LocIndexer  # noqa: F401
