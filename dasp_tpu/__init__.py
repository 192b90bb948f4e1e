"""dasp_tpu — a sparse matrix-vector (SpMV) library in JAX.

A re-design of the DASP algorithm (SC '23,
SuperScientificSoftwareLaboratory/DASP): histogram rows by nonzero count,
pack each category into dense (8 x 128) tile-shaped fragments, and run
dense gather-multiply-reduce strategies per category through XLA — long
rows via chunked partials with a fused reduction tree, medium rows via
transposed SELL slices with adaptive width and spilled tails, short rows
via strided tiles (including the 1+3-nnz pairing trick).

Quick start::

    import dasp_tpu
    csr = dasp_tpu.load_matrix("matrix.mtx")
    op = dasp_tpu.SpMVOperator(csr, dtype="f32")
    y = op(x)
"""

from .config import DaspConfig, DEFAULT_CONFIG
from .sparse import CSRMatrix, from_coo
from .analyze import categorize, RowCategories
from .plan import DaspPlan, build_plan
from .spmv import SpMVOperator, spmv
from .io import load_matrix, read_mtx, write_mtx

__version__ = "0.1.0"


def golden(csr: CSRMatrix, x, dtype: str = "f64"):
    """The float64 CSR product to check a ``dtype`` operator against; for
    "bf16" on bf16-rounded values and x, so what remains is the operator's
    own arithmetic (its f32 sums and bf16 output)."""
    import numpy as np
    if dtype != "bf16":
        return csr.spmv(x)
    import ml_dtypes

    def r(a):
        return np.asarray(a).astype(ml_dtypes.bfloat16).astype(np.float64)
    return CSRMatrix(csr.n_rows, csr.n_cols, csr.row_ptr, csr.col_idx,
                     r(csr.values)).spmv(r(x))


def verify(csr: CSRMatrix, y, x, rtol: float = 1e-5) -> bool:
    """Element-wise verification against the CPU CSR golden — the enabled
    version of the reference's ``verify_new`` (main_f64.cu:3-16, whose call
    is commented out at :157).  Prints a summary and returns pass/fail."""
    import numpy as np
    golden = csr.spmv(x)
    scale = np.maximum(np.abs(golden), 1.0)
    err = np.abs((np.asarray(y, dtype=np.float64) - golden) / scale)
    ok = bool((err <= rtol).all())
    worst = float(err.max()) if err.size else 0.0
    print(f"Y({csr.n_rows}), compute {'succeed' if ok else 'FAILED'}! "
          f"max rel err {worst:.3e} (tol {rtol:g})")
    return ok


__all__ = [
    "DaspConfig", "DEFAULT_CONFIG", "CSRMatrix", "from_coo", "categorize",
    "RowCategories", "DaspPlan", "build_plan", "SpMVOperator", "spmv",
    "load_matrix", "read_mtx", "write_mtx", "golden", "verify",
    "__version__",
]
