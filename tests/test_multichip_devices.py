"""MultiChipSpMV over 1, 2, 4 and 8 virtual CPU devices at every dtype,
against the golden and against the single-device operator."""

import jax
import numpy as np
import pytest

from conftest import TOL, assert_golden
from dasp_tpu import SpMVOperator, golden
from dasp_tpu.parallel import MultiChipSpMV
from dasp_tpu.sparse import powerlaw_like


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
def test_device_counts(n_devices, dtype):
    rng = np.random.default_rng(n_devices)
    csr = powerlaw_like(1500, 1.8, 2000, rng)
    op = MultiChipSpMV(csr, devices=jax.devices()[:n_devices], dtype=dtype)
    assert op.n_devices == n_devices
    assert sum(op.stats["slab_nnz"]) == csr.nnz
    x = rng.standard_normal(csr.n_cols)
    y = op(x)
    assert_golden(y, golden(csr, x, dtype), TOL[dtype])
    # the same product as one device (output rounding aside for bf16)
    single = SpMVOperator(csr, dtype=dtype)(x)
    assert_golden(y, np.asarray(single, dtype=np.float64), TOL[dtype])
