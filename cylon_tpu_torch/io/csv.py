"""CSV read/write with fluent option builders.

Mirror of ``cylon_tpu/io/csv.py``.

reference: cpp/src/cylon/io/csv_read_config.hpp:77-197 (CSVReadOptions — a
fluent builder multiple-inheriting arrow's three csv option structs),
io/arrow_io.cpp:25-50 (read), table_api.cpp:142-212 (write),
table_api.cpp:95-140 (concurrent multi-file read: one thread + promise per
path).  Here the three arrow option structs are pyarrow's
``ReadOptions/ParseOptions/ConvertOptions``, and the thread-per-file read
is a ``ThreadPoolExecutor`` over the GIL-releasing pyarrow reader.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Union

from ..status import Code, CylonError, Status
from ..table import Table


class CSVReadOptions:
    """Fluent builder over pyarrow csv options.

    Mirrors the reference surface (io/csv_read_config.hpp:77-197):
    ``UseThreads``, ``WithDelimiter``, ``IgnoreEmptyLines``,
    ``AutogenerateColumnNames``, ``ColumnNames``, ``BlockSize``,
    ``UseQuoting``, ``DoubleQuote``, ``UseEscaping``, ``EscapingCharacter``,
    ``NullValues``, ``StringsCanBeNull``, ``IncludeColumns``,
    ``WithColumnTypes``, ``SkipRows``, ``ConcurrentFileReads``.
    Snake-case aliases are provided for pythonic use.
    """

    def __init__(self):
        self._use_threads = True
        self._delimiter = ","
        self._ignore_emptylines = True
        self._autogenerate_column_names = False
        self._column_names: Optional[List[str]] = None
        self._block_size = 1 << 20
        self._skip_rows = 0
        self._quoting = True
        self._quote_char = '"'
        self._double_quote = True
        self._escaping = False
        self._escape_char = "\\"
        self._null_values: Optional[List[str]] = None
        self._strings_can_be_null = False
        self._include_columns: Optional[List[str]] = None
        self._column_types: Dict[str, object] = {}
        self._concurrent_file_reads = True

    # -- reference-style fluent methods --------------------------------------

    def UseThreads(self, v: bool = True):
        self._use_threads = v
        return self

    def WithDelimiter(self, d: str):
        self._delimiter = d
        return self

    def IgnoreEmptyLines(self, v: bool = True):
        self._ignore_emptylines = v
        return self

    def AutogenerateColumnNames(self, v: bool = True):
        self._autogenerate_column_names = v
        return self

    def ColumnNames(self, names: Sequence[str]):
        self._column_names = list(names)
        return self

    def BlockSize(self, n: int):
        self._block_size = int(n)
        return self

    def SkipRows(self, n: int):
        self._skip_rows = int(n)
        return self

    def UseQuoting(self, v: bool = True):
        self._quoting = v
        return self

    def WithQuoteChar(self, c: str):
        self._quote_char = c
        return self

    def DoubleQuote(self, v: bool = True):
        self._double_quote = v
        return self

    def UseEscaping(self, v: bool = True):
        self._escaping = v
        return self

    def EscapingCharacter(self, c: str):
        self._escape_char = c
        return self

    def NullValues(self, vals: Sequence[str]):
        self._null_values = list(vals)
        return self

    def StringsCanBeNull(self, v: bool = True):
        self._strings_can_be_null = v
        return self

    def IncludeColumns(self, cols: Sequence[str]):
        self._include_columns = list(cols)
        return self

    def WithColumnTypes(self, types: Dict[str, object]):
        """name → pyarrow DataType (or anything ``pa.csv`` accepts)."""
        self._column_types = dict(types)
        return self

    def ConcurrentFileReads(self, v: bool = True):
        self._concurrent_file_reads = v
        return self

    # snake_case aliases
    use_threads = UseThreads
    with_delimiter = WithDelimiter
    ignore_emptylines = IgnoreEmptyLines
    block_size = BlockSize
    skip_rows = SkipRows
    null_values = NullValues
    include_columns = IncludeColumns
    with_column_types = WithColumnTypes
    concurrent_file_reads = ConcurrentFileReads

    # -- lowering to pyarrow --------------------------------------------------

    def to_pyarrow(self):
        import pyarrow.csv as pacsv

        read = pacsv.ReadOptions(
            use_threads=self._use_threads,
            block_size=self._block_size,
            skip_rows=self._skip_rows,
            column_names=self._column_names,
            autogenerate_column_names=self._autogenerate_column_names,
        )
        parse = pacsv.ParseOptions(
            delimiter=self._delimiter,
            quote_char=self._quote_char if self._quoting else False,
            double_quote=self._double_quote,
            escape_char=self._escape_char if self._escaping else False,
            ignore_empty_lines=self._ignore_emptylines,
        )
        conv_kwargs = dict(
            column_types=self._column_types or None,
            include_columns=self._include_columns,
            strings_can_be_null=self._strings_can_be_null,
        )
        if self._null_values is not None:
            conv_kwargs["null_values"] = self._null_values
        convert = pacsv.ConvertOptions(**conv_kwargs)
        return read, parse, convert


class CSVWriteOptions:
    """reference: io/csv_write_config.hpp:53-73."""

    def __init__(self):
        self._delimiter = ","
        self._column_names: Optional[List[str]] = None

    def WithDelimiter(self, d: str):
        self._delimiter = d
        return self

    def ColumnNames(self, names: Sequence[str]):
        self._column_names = list(names)
        return self

    with_delimiter = WithDelimiter
    column_names = ColumnNames


def _read_one(path: str, options: CSVReadOptions):
    import pyarrow.csv as pacsv

    from .. import faults, resilience

    read, parse, convert = options.to_pyarrow()

    def attempt():
        # fault point: a flaky filesystem / object store read;
        # resilience.retry_call absorbs the transient class
        faults.check("io.csv.read")
        return pacsv.read_csv(path, read_options=read,
                              parse_options=parse,
                              convert_options=convert)

    try:
        return resilience.retry_call(attempt, point="io.csv.read")
    except faults.FaultError:
        raise  # already a typed CylonError naming the fault point
    except FileNotFoundError as e:
        raise CylonError(Status(Code.IOError, str(e))) from e
    except Exception as e:  # pyarrow raises ArrowInvalid etc.
        raise CylonError(Status(Code.IOError, f"{path}: {e}")) from e


def read_csv(ctx, path: Union[str, Sequence[str]],
             options: Optional[CSVReadOptions] = None
             ) -> Union[Table, List[Table]]:
    """Read one CSV into a device Table, or several (see ``read_csv_many``).

    reference: io/arrow_io.cpp:25-50 + table_api.cpp:75-93 (single file),
    table_api.cpp:95-140 (multi file).
    """
    if options is None:
        options = CSVReadOptions()
    if not isinstance(path, str):
        return read_csv_many(ctx, path, options)
    return Table.from_arrow(ctx, _read_one(path, options))


def read_csv_many(ctx, paths: Sequence[str],
                  options: Optional[CSVReadOptions] = None) -> List[Table]:
    """Concurrent multi-file read: a thread per path when
    ``ConcurrentFileReads`` (the default), else sequential.

    reference: table_api.cpp:95-140 — one std::thread + promise per path.
    """
    if options is None:
        options = CSVReadOptions()
    if options._concurrent_file_reads and len(paths) > 1:
        workers = min(len(paths), os.cpu_count() or 8, 32)
        with ThreadPoolExecutor(max_workers=workers) as ex:
            atables = list(ex.map(lambda p: _read_one(p, options), paths))
    else:
        atables = [_read_one(p, options) for p in paths]
    return [Table.from_arrow(ctx, at) for at in atables]


def write_csv(table: Table, path: str,
              options: Optional[CSVWriteOptions] = None) -> None:
    """Write a Table to CSV.

    reference: table_api.cpp:142-212 (WriteCSV) — the reference stringifies
    row-wise; arrow's writer is the faithful-but-faster equivalent.  A
    non-comma delimiter falls back to pandas (arrow's writer is
    comma-only).
    """
    if options is None:
        options = CSVWriteOptions()
    at = table.to_arrow()
    if options._column_names is not None:
        at = at.rename_columns(options._column_names)
    if options._delimiter == ",":
        import pyarrow.csv as pacsv

        pacsv.write_csv(at, path)
    else:
        at.to_pandas().to_csv(path, sep=options._delimiter, index=False)
