"""``table._encode_dictionary_indices`` (the ingest of an Arrow dictionary
column, a pandas ``Categorical``, from its indices) against
``table._encode_dictionary`` of the same column decoded to its value
type: the same codes, dictionary and validity.  Covers nulls, unused and
unsorted categories, an empty dictionary with every row null, an empty
column, and a multi-chunk column through ``host_columns_from_arrow``."""
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest

from cylon_tpu_torch.table import (_encode_dictionary,
                                   _encode_dictionary_indices,
                                   host_columns_from_arrow)


def _dict_array(indices, dictionary, value_type=pa.string()):
    return pa.DictionaryArray.from_arrays(
        pa.array(indices, type=pa.int32()),
        pa.array(dictionary, type=value_type))


CASES = {
    "sorted": ([0, 1, 2, 1, 0], ["a", "b", "c"]),
    "nulls": ([0, None, 2, None, 1], ["a", "b", "c"]),
    "unused": ([3, 1, 3, 1], ["w", "x", "y", "z"]),
    "unsorted": ([0, 1, 2, 0, 3], ["pear", "apple", "fig", "banana"]),
    "unsorted-unused-nulls": ([2, None, 0, 2, None],
                              ["zeta", "alpha", "mu", "beta"]),
    "empty-dictionary-all-null": ([None, None, None], []),
    "empty-column": ([], ["b", "a"]),
    "all-null": ([None, None], ["b", "a"]),
}


def _same(got, want):
    (gc, gd, gv), (wc, wd, wv) = got, want
    assert gc.dtype == wc.dtype == np.int32
    np.testing.assert_array_equal(gc, wc)
    assert list(gd) == list(wd) and gd.dtype == wd.dtype
    assert (gv is None) == (wv is None)
    if wv is not None:
        np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("value_type", [pa.string(), pa.large_string()],
                         ids=["string", "large_string"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_indices_encode_equals_decoded_encode(case, value_type):
    arr = _dict_array(*CASES[case], value_type=value_type)
    _same(_encode_dictionary_indices(arr),
          _encode_dictionary(arr.cast(value_type)))


def test_multi_chunk_column():
    """Chunks with dictionaries of their own (different order, unused
    values, nulls) ingest as the same column decoded to strings."""
    chunks = [_dict_array([1, None, 0], ["q", "b", "k"]),
              _dict_array([0, 2, 2, None], ["k", "unused", "a"]),
              _dict_array([None], [])]
    col = pa.chunked_array(chunks)
    got = host_columns_from_arrow(pa.table({"c": col}))
    want = host_columns_from_arrow(pa.table({"c": col.cast(pa.string())}))
    (gn, gt, gc, gv, gd, gvt), = got
    (wn, wt, wc, wv, wd, wvt), = want
    assert (gn, gt, gvt) == (wn, wt, wvt)
    _same((gc, gd, gv), (wc, wd, wv))


def test_categorical_frame():
    """A pandas ``Categorical`` with unsorted, unused categories and
    missing values, as ``DTable.from_pandas`` hands it to Arrow."""
    cat = pd.Categorical(["mu", None, "alpha", "mu", "zeta", None],
                         categories=["zeta", "omega", "mu", "alpha"])
    atable = pa.Table.from_pandas(pd.DataFrame({"c": cat}),
                                  preserve_index=False)
    assert pa.types.is_dictionary(atable.schema.field("c").type)
    got, = host_columns_from_arrow(atable)
    want, = host_columns_from_arrow(atable.cast(
        pa.schema([pa.field("c", pa.string())])))
    _same((got[2], got[4], got[3]), (want[2], want[4], want[3]))
