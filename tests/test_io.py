"""Matrix Market parser tests (semantics of mmio_highlevel.h:608-774)."""

import io

import numpy as np
import pytest

from dasp_tpu.io.mmio import MatrixMarketError, read_mtx, write_mtx  # noqa
from dasp_tpu.sparse import mixed_categories


def _parse(text):
    return read_mtx(io.BytesIO(text.encode()))


def test_general_real():
    csr = _parse("""%%MatrixMarket matrix coordinate real general
% a comment
3 3 4
1 1 2.0
2 3 -1.5
3 1 4.0
3 3 1.0
""")
    np.testing.assert_array_equal(
        csr.to_dense(), [[2, 0, 0], [0, 0, -1.5], [4, 0, 1]])


def test_symmetric_expansion():
    csr = _parse("""%%MatrixMarket matrix coordinate real symmetric
3 3 3
1 1 1.0
2 1 5.0
3 3 2.0
""")
    np.testing.assert_array_equal(
        csr.to_dense(), [[1, 5, 0], [5, 0, 0], [0, 0, 2]])


def test_skew_symmetric_negates():
    csr = _parse("""%%MatrixMarket matrix coordinate real skew-symmetric
2 2 1
2 1 3.0
""")
    np.testing.assert_array_equal(csr.to_dense(), [[0, -3], [3, 0]])


def test_pattern_gets_ones():
    csr = _parse("""%%MatrixMarket matrix coordinate pattern symmetric
2 2 2
1 1
2 1
""")
    np.testing.assert_array_equal(csr.to_dense(), [[1, 1], [1, 0]])


def test_complex_keeps_real_part():
    csr = _parse("""%%MatrixMarket matrix coordinate complex general
2 2 1
1 2 2.5 -7.0
""")
    np.testing.assert_array_equal(csr.to_dense(), [[0, 2.5], [0, 0]])


def test_integer_field():
    csr = _parse("""%%MatrixMarket matrix coordinate integer general
2 2 2
1 1 3
2 2 -4
""")
    np.testing.assert_array_equal(csr.to_dense(), [[3, 0], [0, -4]])


def test_array_format():
    csr = _parse("""%%MatrixMarket matrix array real general
2 2
1.0
0.0
3.0
4.0
""")
    np.testing.assert_array_equal(csr.to_dense(), [[1, 3], [0, 4]])


def test_bad_banner_raises():
    with pytest.raises(MatrixMarketError):
        _parse("%%NotMatrixMarket matrix coordinate real general\n1 1 0\n")


def test_nnz_mismatch_raises():
    with pytest.raises(MatrixMarketError):
        _parse("""%%MatrixMarket matrix coordinate real general
2 2 3
1 1 1.0
""")


def test_write_read_roundtrip(tmp_path, rng):
    csr = mixed_categories(120, rng)
    p = tmp_path / "m.mtx"
    write_mtx(p, csr)
    back = read_mtx(p)
    np.testing.assert_allclose(back.to_dense(), csr.to_dense(), rtol=1e-15)


def test_native_parser_matches_python(tmp_path, rng):
    """The C++ parser (native/mmio.cpp) must agree with the Python oracle."""
    from dasp_tpu.io import native
    if not native.available():
        import pytest
        pytest.skip("libdasp_host.so not built")
    csr = mixed_categories(200, rng)
    p = tmp_path / "n.mtx"
    write_mtx(p, csr)
    a = read_mtx(p)
    b = native.read_mtx(p)
    np.testing.assert_array_equal(a.row_ptr, b.row_ptr)
    np.testing.assert_array_equal(a.col_idx, b.col_idx)
    np.testing.assert_allclose(a.values, b.values, rtol=1e-14)


def test_native_parser_symmetric(tmp_path):
    from dasp_tpu.io import native
    if not native.available():
        import pytest
        pytest.skip("libdasp_host.so not built")
    p = tmp_path / "s.mtx"
    p.write_text("""%%MatrixMarket matrix coordinate real symmetric
3 3 3
1 1 1.5
2 1 -2e3
3 3 4.25
""")
    a = read_mtx(p)
    b = native.read_mtx(p)
    np.testing.assert_array_equal(a.to_dense(), b.to_dense())
