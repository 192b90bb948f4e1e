"""The XLA executor against the float64 CSR golden: row-family generator
cases at every dtype, a seeded fuzz of the packer's tunables, DaspConfig
edge cases, and the chained timing loop."""

import dataclasses

import numpy as np
import pytest

from conftest import TOL, assert_golden, mass_of
from dasp_tpu import DaspConfig, SpMVOperator, build_plan, golden
from dasp_tpu.sparse import (circuit_like, fem_like, mixed_categories,
                             powerlaw_like, random_csr)

CASES = {
    "tiny": lambda rng: random_csr(10, 12, np.array(
        [0, 1, 2, 3, 4, 5, 9, 2, 0, 7]), rng),
    "fem": lambda rng: fem_like(400, 20, rng),
    "mixed": lambda rng: mixed_categories(500, rng),
    "powerlaw": lambda rng: powerlaw_like(400, 1.8, 3000, rng),
    # few rows over many columns: scattered x reads
    "scattered": lambda rng: random_csr(
        300, 5000, rng.integers(1, 60, 300), rng),
    "wide_cols": lambda rng: random_csr(
        64, 300_000, rng.integers(1, 40, 64), rng),
    # duplicate-heavy power-law columns with a long hub tail
    "powerlaw_deg": lambda rng: powerlaw_like(20_000, 1.7, 20_000, rng,
                                              col_alpha=1.6),
    # long rows with uniform columns over a wide range, between short rows
    "scattered_long": lambda rng: random_csr(
        200, 400_000, np.where(np.arange(200) % 50 == 0, 2000, 3), rng),
    # circuit archetype: short rows + sparse medium rows + a few rails
    "circuit": lambda rng: circuit_like(6000, rng),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
def test_case_matches_golden(rng, name, dtype):
    csr = CASES[name](rng)
    x = rng.standard_normal(csr.n_cols)
    y = SpMVOperator(csr, dtype=dtype)(x)
    assert y.shape == (csr.n_rows,)
    assert_golden(y, golden(csr, x, dtype), TOL[dtype], mass_of(csr, x))


def _fuzz_matrix(rng):
    """Rows from every family: empty, 1..4 nnz, medium, long."""
    n = int(rng.integers(200, 800))
    kind = rng.choice(4, size=n, p=[0.1, 0.5, 0.35, 0.05])
    lens = np.select(
        [kind == 0, kind == 1, kind == 2],
        [0, rng.integers(1, 5, n), rng.integers(5, 300, n)],
        rng.integers(300, 3000, n))
    n_cols = int(rng.integers(max(lens.max(), 1), 6000))
    return random_csr(n, n_cols, lens, rng)


def _fuzz_config(rng):
    block_longest = int(rng.choice([5, 8, 17, 64, 256, 700]))
    top = -(-block_longest // 8) * 8
    extra = rng.choice(np.arange(8, top, 8), size=min(4, top // 8 - 1),
                       replace=False) if top > 8 else []
    buckets = tuple(sorted({top, *map(int, extra)}))
    return DaspConfig(block_longest=block_longest,
                      threshold=float(rng.uniform(0.2, 1.0)),
                      width_buckets=buckets,
                      pair_13=bool(rng.integers(2)),
                      pair_13_min_slots=int(rng.choice([1, 16, 128])))


@pytest.mark.parametrize("seed", range(1, 9))
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_packer_fuzz(seed, dtype):
    """Random tunables (long-row cut, occupancy threshold, 1&3 pairing,
    width buckets) on a random all-family matrix: every plan computes
    the golden product."""
    rng = np.random.default_rng(seed)
    csr = _fuzz_matrix(rng)
    config = _fuzz_config(rng)
    plan = build_plan(csr, config)
    assert plan.nnz == csr.nnz
    x = rng.standard_normal(csr.n_cols)
    assert_golden(SpMVOperator(plan, dtype=dtype)(x), csr.spmv(x),
                  TOL[dtype], mass_of(csr, x))


@pytest.mark.parametrize("block_longest", [5, 32, 256])
@pytest.mark.parametrize("threshold", [0.5, 1.0])
@pytest.mark.parametrize("pair_13", [True, False])
def test_config_edges(rng, block_longest, threshold, pair_13):
    lens = np.concatenate([np.full(300, 1), np.full(300, 3),
                           rng.integers(0, 400, 300)])
    csr = random_csr(lens.size, 2000, rng.permutation(lens), rng)
    config = DaspConfig(block_longest=block_longest, threshold=threshold,
                        pair_13=pair_13)
    plan = build_plan(csr, config)
    assert (plan.pair13 is not None) == pair_13
    assert (plan.long is not None) == bool(
        (csr.row_lengths >= block_longest).any())
    x = rng.standard_normal(csr.n_cols)
    assert_golden(SpMVOperator(plan, dtype="f32")(x), csr.spmv(x),
                  TOL["f32"], mass_of(csr, x))


@pytest.mark.parametrize("dtype", ["f32", "bf16", "f64"])
def test_timing_loop_equals_call(rng, dtype):
    """The chained timing loop computes the plain product: its 1e-36
    perturbation of x is below every dtype's resolution."""
    csr = mixed_categories(400, rng)
    op = SpMVOperator(csr, dtype=dtype)
    x_dev = op._prep_x(rng.standard_normal(csr.n_cols))
    y_call = op.device_call(x_dev)
    y_loop = op.timing_loop(3)(x_dev)
    for a, b in zip(*(jax_leaves(y) for y in (y_call, y_loop))):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def jax_leaves(y):
    import jax
    return [np.asarray(v, dtype=np.float64) for v in jax.tree.leaves(y)]


def test_config_rejects_bad_values():
    for bad in (dict(block_longest=4), dict(threshold=0.0),
                dict(width_buckets=(8, 12, 256)),
                dict(width_buckets=(16, 8, 256)),
                dict(width_buckets=(8, 16)), dict(long_chunk=100)):
        with pytest.raises(ValueError):
            dataclasses.replace(DaspConfig(), **bad)


def test_bf16_products_are_exact_in_f32():
    """bf16 operands are multiplied in f32, where their product is exact:
    (1 + 2^-7)^2 = 1 + 2^-6 + 2^-14 needs 15 mantissa bits, which a bf16
    product would round away before the f32 sum."""
    import jax.numpy as jnp
    from dasp_tpu.ops.xla_backend import _Alg
    a = jnp.full((4,), 1 + 2.0 ** -7, jnp.bfloat16)
    p = _Alg("bf16").mul(a, a)
    assert p.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(p), 1 + 2.0 ** -6 + 2.0 ** -14)
