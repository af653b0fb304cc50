"""I/O layer: CSV ingest and egress through pyarrow on the host, then the
host→device transfer.

Mirror of ``cylon_tpu/io``.  The reference memory-maps files into
``arrow::csv::TableReader`` (reference: cpp/src/cylon/io/arrow_io.cpp:25-50);
pyarrow's reader is the same C++ underneath.  Device residency happens at
``Table.from_arrow`` (or ``DTable.from_partitions`` of the tables read).
"""
from .csv import (CSVReadOptions, CSVWriteOptions, read_csv, read_csv_many,
                  write_csv)

__all__ = ["CSVReadOptions", "CSVWriteOptions", "read_csv", "read_csv_many",
           "write_csv"]
