"""Files in and out (counterpart of cylon_tpu/io): CSV through the native
codec (``native/``), parquet through pyarrow."""
from .csv import CSVReadOptions, CSVWriteOptions, read_csv, write_csv
from .parquet import ParquetOptions, read_parquet, write_parquet

__all__ = [
    "CSVReadOptions",
    "CSVWriteOptions",
    "ParquetOptions",
    "read_csv",
    "write_csv",
    "read_parquet",
    "write_parquet",
]
