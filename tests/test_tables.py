import numpy as np
import pytest

from saamge_jax.utils.tables import Table


def test_transpose_roundtrip():
    t = Table.from_rows([[0, 2], [1], [0, 1, 3]], 4)
    tt = t.transpose()
    assert tt.nrows == 4
    assert list(tt.row(0)) == [0, 2]
    assert list(tt.row(1)) == [1, 2]
    assert list(tt.row(3)) == [2]
    ttt = tt.transpose()
    assert np.array_equal(ttt.indptr, t.indptr)
    # transpose of transpose has sorted rows; original rows were sorted
    assert np.array_equal(ttt.indices, t.indices)


def test_mult_boolean_first_encounter():
    a = Table.from_rows([[1, 0]], 2)          # one row, cols in order 1,0
    b = Table.from_rows([[5, 6], [6, 7]], 8)  # row1 first!
    c = a.mult(b)
    # row 0 of a hits b-rows 1 then 0 -> cols 6,7 then 5 (6 deduped)
    assert list(c.row(0)) == [6, 7, 5]
    assert c.ncols == 8


def test_from_partition():
    part = np.array([1, 0, 1, 1, 0])
    t = Table.from_partition(part, 2)
    assert list(t.row(0)) == [1, 4]
    assert list(t.row(1)) == [0, 2, 3]


def test_mult_matches_scipy_pattern():
    rng = np.random.default_rng(0)
    import scipy.sparse as sp
    A = sp.random(30, 40, density=0.1, random_state=0).tocsr()
    B = sp.random(40, 25, density=0.1, random_state=1).tocsr()
    ta = Table(A.indptr.astype(np.int64), A.indices.astype(np.int64), 40)
    tb = Table(B.indptr.astype(np.int64), B.indices.astype(np.int64), 25)
    tc = ta.mult(tb)
    C = (A @ B).tocsr()
    C.sort_indices()
    for i in range(30):
        assert set(tc.row(i)) == set(C.indices[C.indptr[i]:C.indptr[i + 1]])


def test_mult_empty_rectangular_right_factor():
    # an all-empty right factor selects the rectangular fast
    # path with k=0; must return an empty product, not raise
    a = Table.from_rows(np.array([[0]]), 1)
    b = Table.from_rows([[]], 1)
    c = a.mult(b)
    assert c.nrows == 1 and c.nnz == 0 and c.ncols == 1


def test_group_rows_zero_width():
    from saamge_jax.utils.tables import group_rows
    inv, num = group_rows(np.zeros((5, 0), dtype=np.int64))
    assert num == 1 and np.array_equal(inv, np.zeros(5, dtype=np.int64))
    inv0, num0 = group_rows(np.zeros((0, 0), dtype=np.int64))
    assert num0 == 0 and len(inv0) == 0
