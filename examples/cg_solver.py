#!/usr/bin/env python
"""Conjugate-gradient solve with dasp_tpu — the canonical SpMV consumer.

Solves A x = b for a symmetric positive-definite A, keeping the whole
iteration on device: the packed SpMV (the XLA executor's ``spmv_fn`` on
the operator's device arrays) is jitted together with the CG vector
updates, so one `solve` call runs every iteration without host round trips.

Usage: python examples/cg_solver.py [n]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))


def build_spd(n: int, rng) -> "dasp_tpu.CSRMatrix":
    """A = tridiagonal-ish SPD matrix (2D-Laplacian flavored)."""
    import dasp_tpu
    rows, cols, vals = [], [], []
    for off, v in ((0, 4.0), (1, -1.0), (-1, -1.0), (64, -1.0), (-64, -1.0)):
        r = np.arange(max(0, -off), min(n, n - off))
        rows.append(r)
        cols.append(r + off)
        vals.append(np.full(r.size, v))
    return dasp_tpu.from_coo(n, n, np.concatenate(rows),
                             np.concatenate(cols).astype(np.int32),
                             np.concatenate(vals), sum_duplicates=True)



def cg_solve_dd(op, b: np.ndarray, tol: float = None,
                maxiter: int = 4000):
    """CG in double-double (f32x2) precision on device: op is an
    SpMVOperator built with dtype="f64".  f32 CG stalls around 1e-3-1e-4
    relative error on ill-conditioned Laplacians; the dd state vectors,
    dd matvec and compensated dd dot products restore fp64-grade
    convergence (the reference's spmv_double consumer story,
    main_f64.cu)."""
    import jax
    import jax.numpy as jnp
    from dasp_tpu.ops import dd
    from dasp_tpu.ops.xla_backend import spmv_fn

    meta, arrays = op._meta, op._arrays
    n = op.n_rows

    def matvec(xh, xl):
        y = spmv_fn(meta, arrays, dict(hi=xh, lo=xl))
        return y["hi"], y["lo"]

    @jax.jit
    def solve(bh, bl):
        def body(state):
            (xh, xl), (rh, rl), (ph, pl), (rsh, rsl), it = state
            aph, apl = matvec(ph, pl)
            dh, dl = dd.dot(ph, pl, aph, apl, safe=True)
            alh, all_ = dd.div(rsh, rsl, dh, dl, safe=True)
            sh, sl = dd.mul(ph, pl, alh, all_, safe=True)
            xh, xl = dd.add(xh, xl, sh, sl, safe=True)
            th, tl = dd.mul(aph, apl, alh, all_, safe=True)
            rh, rl = dd.add(rh, rl, -th, -tl, safe=True)
            nsh, nsl = dd.dot(rh, rl, rh, rl, safe=True)
            beh, bel = dd.div(nsh, nsl, rsh, rsl, safe=True)
            qh, ql = dd.mul(ph, pl, beh, bel, safe=True)
            ph, pl = dd.add(rh, rl, qh, ql, safe=True)
            return (xh, xl), (rh, rl), (ph, pl), (nsh, nsl), it + 1

        def cond(state):
            _, _, _, (rsh, _), it = state
            return (rsh > jnp.float32(tol * tol)) & (it < maxiter)

        z = jnp.zeros(n, jnp.float32)
        state = ((z, z), (bh, bl), (bh, bl),
                 dd.dot(bh, bl, bh, bl, safe=True), 0)
        (xh, xl), _, _, (rsh, _), it = jax.lax.while_loop(cond, body,
                                                          state)
        return xh, xl, jnp.sqrt(rsh), it

    b = np.asarray(b, dtype=np.float64)
    if tol is None:
        tol = 1e-10 * float(np.linalg.norm(b))
    bh, bl = dd.from_f64(b)
    xh, xl, res, it = solve(jnp.asarray(bh), jnp.asarray(bl))
    return dd.to_f64(np.asarray(xh), np.asarray(xl)), res, it


def cg_solve(op, b: np.ndarray, tol: float = 1e-6, maxiter: int = 500):
    """CG on device: op is an SpMVOperator built with dtype="f32"."""
    import jax
    import jax.numpy as jnp
    from dasp_tpu.ops.xla_backend import spmv_fn

    meta, arrays = op._meta, op._arrays

    @jax.jit
    def solve(b):
        def body(state):
            x, r, p, rs, it = state
            ap = spmv_fn(meta, arrays, p)
            alpha = rs / jnp.dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            rs_new = jnp.dot(r, r)
            p = r + (rs_new / rs) * p
            return x, r, p, rs_new, it + 1

        def cond(state):
            _, _, _, rs, it = state
            return (rs > tol * tol) & (it < maxiter)

        x0 = jnp.zeros_like(b)
        state = (x0, b, b, jnp.dot(b, b), 0)
        x, r, _, rs, it = jax.lax.while_loop(cond, body, state)
        return x, jnp.sqrt(rs), it

    # the executor returns y in original row order, so y feeds straight
    # back as the next x
    x, res, it = solve(jnp.asarray(np.asarray(b, dtype=np.float32)))
    return np.asarray(x), res, it


def main():
    import jax.numpy as jnp  # noqa: F401  (import check)
    import dasp_tpu

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 65536
    dtype = sys.argv[2] if len(sys.argv) > 2 else "f64"
    rng = np.random.default_rng(0)
    csr = build_spd(n, rng)
    op = dasp_tpu.SpMVOperator(csr, dtype=dtype)
    x_true = rng.standard_normal(n)
    b = csr.spmv(x_true)

    if dtype == "f64":
        x, res, iters = cg_solve_dd(op, b)
    else:
        x, res, iters = cg_solve(op, b.astype(np.float32))
    x = np.asarray(x, dtype=np.float64)
    err = np.linalg.norm(x - x_true) / np.linalg.norm(x_true)
    print(f"CG[{dtype}]: n={n} iters={int(iters)} "
          f"residual={float(res):.3e} solution rel err={err:.3e}")
    # f32 CG stalls near 1e-3 on ill-conditioned systems; dd restores
    # fp64-grade accuracy
    return 0 if err < (1e-3 if dtype == "f32" else 1e-6) else 1


if __name__ == "__main__":
    sys.exit(main())
