#!/usr/bin/env python
"""PageRank with dasp_tpu — the canonical power-law-graph SpMV consumer.

Power iteration r <- d * A^T_colnorm r + (1-d)/n, with the whole loop
on device: the packed SpMV (the XLA executor's ``spmv_fn``) jits together
with the rank updates, so one call runs every iteration without host round
trips.  Exercises exactly
the short-row / long-row mix the wikitalk-like benchmark measures.

Usage: python examples/pagerank.py [n]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))


def build_transition(n: int, rng) -> "dasp_tpu.CSRMatrix":
    """Column-normalized transposed adjacency of a power-law digraph
    (rows = destinations): r_new[dst] = sum_src P[dst,src] r[src]."""
    import dasp_tpu
    out_deg = np.minimum(rng.zipf(1.9, size=n), n // 2)
    src = np.repeat(np.arange(n), out_deg)
    dst = (np.minimum(rng.zipf(1.7, size=src.size), n) - 1).astype(np.int32)
    vals = 1.0 / np.repeat(out_deg.astype(np.float64), out_deg)
    return dasp_tpu.from_coo(n, n, dst, src.astype(np.int32), vals,
                             sum_duplicates=True)


def pagerank(op, damping: float = 0.85, iters: int = 50):
    """``iters`` power iterations plus a final product, all on device; op
    is an SpMVOperator built with dtype="f32"."""
    import jax
    import jax.numpy as jnp
    from dasp_tpu.ops.xla_backend import spmv_fn

    meta, arrays = op._meta, op._arrays
    # cache the jitted loop per (damping, iters): a fresh jit every call
    # would retrace and re-dispatch the whole program each time
    cache = getattr(op, "_pagerank_jit", None)
    if cache is None:
        cache = op._pagerank_jit = {}
    run = cache.get((damping, iters))
    if run is None:
        n = op.n_rows
        teleport = (1.0 - damping) / n

        @jax.jit
        def run(arrays):
            def body(_, r):
                r = damping * spmv_fn(meta, arrays, r) + teleport
                # dangling mass redistributes uniformly (columns with no
                # outlinks contribute nothing through A; renormalize)
                return r / jnp.sum(r)

            r = jax.lax.fori_loop(0, iters, body,
                                  jnp.full(n, 1.0 / n, jnp.float32))
            return spmv_fn(meta, arrays, r) * damping + teleport

        cache[damping, iters] = run
    return np.asarray(run(arrays))


def main():
    import time
    import dasp_tpu
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    rng = np.random.default_rng(0)
    csr = build_transition(n, rng)
    print(f"graph: {n} nodes, {csr.nnz} edges")
    t0 = time.time()
    op = dasp_tpu.SpMVOperator(csr, dtype="f32")
    print(f"pack+upload setup: {time.time() - t0:.1f}s")
    pagerank(op)                           # compile warmup (same trace)
    t0 = time.time()
    r = pagerank(op)
    dt = time.time() - t0
    print(f"50 iterations in {dt:.2f}s ({dt / 50 * 1e3:.1f} ms/iter)")
    top = np.argsort(-r)[:5]
    print("top-5 nodes:", list(zip(top.tolist(), np.round(r[top], 6))))
    # golden check against host power iteration
    rh = np.full(n, 1.0 / n)
    for _ in range(50):
        rh = 0.85 * csr.spmv(rh) + 0.15 / n
        rh = rh / rh.sum()
    rh = 0.85 * csr.spmv(rh) + 0.15 / n
    err = np.abs(r - rh).max() / np.abs(rh).max()
    print(f"vs host power iteration: rel err {err:.2e}")
    return 0 if err < 1e-3 else 1


if __name__ == "__main__":
    sys.exit(main())
