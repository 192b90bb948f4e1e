"""Competitor baselines.

``jax.experimental.sparse`` BCOO SpMV plays the role cuSPARSE plays for the
reference (``main_f64.cu:19-100``): the general-purpose sparse product of
the JAX stack, lowered by XLA's gather/scatter.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.xla_backend import perturb_x
from ..sparse import CSRMatrix


class BCOOBaseline:
    """BCOO SpMV wrapper with the same interface as SpMVOperator."""

    def __init__(self, csr: CSRMatrix, dtype: str = "f32"):
        from jax.experimental import sparse as jsparse

        t0 = time.perf_counter()
        self.n_rows, self.n_cols, self.nnz = csr.n_rows, csr.n_cols, csr.nnz
        rows = np.repeat(np.arange(csr.n_rows), csr.row_lengths)
        indices = np.stack([rows, csr.col_idx.astype(np.int64)],
                           axis=1).astype(np.int32)
        want = jnp.bfloat16 if dtype == "bf16" else jnp.float32
        self.dtype = dtype
        self.mat = jsparse.BCOO(
            (jnp.asarray(csr.values, dtype=want), jnp.asarray(indices)),
            shape=(csr.n_rows, csr.n_cols))
        self._fn = jax.jit(lambda m, v: m @ v)
        self.preprocess_seconds = time.perf_counter() - t0

    def _prep_x(self, x):
        want = jnp.bfloat16 if self.dtype == "bf16" else jnp.float32
        return jnp.asarray(np.asarray(x)).astype(want)

    def device_call(self, x_dev):
        return self._fn(self.mat, x_dev)

    def timing_loop(self, iters: int):
        # runtime iteration count: one compile serves every loop length
        loop = getattr(self, "_loop_jit", None)
        if loop is None:
            @jax.jit
            def loop(mat, x, it):
                def body(_, x):
                    return perturb_x(x, mat @ x)
                x = jax.lax.fori_loop(0, it, body, x)
                return mat @ x
            self._loop_jit = loop
        it = jnp.int32(iters)
        return lambda x_dev: loop(self.mat, x_dev, it)

    def __call__(self, x):
        return np.asarray(self.device_call(self._prep_x(x)))
