"""XLA executor: runs a DaspPlan's packed structures as fused jnp ops.

This backend expresses every strategy as gather -> multiply -> dense
reduction, letting XLA fuse each structure into a single pass over device
memory.  It is the one device path: XLA emits the per-element x gathers
directly, and the same code runs on the CPU (tests) and the GPU.

Structure-to-op mapping (reference parity):
  * ShortStream (stride s)  <-  short1/22/34 kernels ``dasp_f64.h:283-483``:
      reshape (T, 8/s, s, 128), sum over the stride axis.
  * Pair13Stream            <-  the 1&3 masked-B MMA ``dasp_f64.h:298-355``:
      slot element 0 -> y1, elements 1..3 summed -> y3.
  * SellGroup               <-  medium row-block MMA loop ``dasp_f64.h:147-279``:
      sum over the width (sublane) axis, emitting 128 rows per slice.
  * remainder SellGroup     <-  irregular CSR tail ``dasp_f64.h:184-195``:
      same reduction, scatter-added into y_perm.
  * LongStream              <-  long-part MMA + ``longPart_sum``
      (``dasp_f64.h:92-125`` + ``:53-75``): per-chunk partial sums reduced
      through the plan's static power-of-two gather tree — the second kernel
      is fused away.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..plan import DaspPlan
from . import dd

# dtype tags
F32, BF16, F64 = "f32", "bf16", "f64"
_JNP = {F32: jnp.float32, BF16: jnp.bfloat16}


class PlanMeta(NamedTuple):
    """Hashable static structure of a lowered plan (jit static arg)."""
    dtype: str
    strides: Tuple[int, ...]   # one per ShortStream, in array order
    n_perm: int


def _dev_vals(a: np.ndarray, dtype: str):
    if dtype == F64:
        return dict(zip(("hi", "lo"), dd.from_f64(a)))
    return a.astype(_JNP[dtype])


def plan_to_arrays(plan: DaspPlan, dtype: str) -> Tuple[PlanMeta, Dict]:
    """Lower a host plan to (static meta, pytree of device-ready arrays)."""
    t: Dict = {}
    t["shorts"] = [dict(vals=_dev_vals(s.vals, dtype), cols=s.cols)
                   for s in plan.shorts]
    t["pair13"] = (dict(vals=_dev_vals(plan.pair13.vals, dtype),
                        cols=plan.pair13.cols)
                   if plan.pair13 else None)
    t["sell"] = [dict(vals=_dev_vals(g.vals, dtype), cols=g.cols)
                 for g in plan.sell]
    t["remainder"] = [dict(vals=_dev_vals(g.vals, dtype), cols=g.cols,
                           pos=g.out_pos.reshape(-1))
                      for g in plan.remainder]
    t["long"] = (dict(vals=_dev_vals(plan.long.vals, dtype),
                      cols=plan.long.cols,
                      buckets=[b for b in plan.long.buckets])
                 if plan.long else None)
    t["inv_perm"] = plan.inv_perm
    meta = PlanMeta(dtype=dtype,
                    strides=tuple(s.stride for s in plan.shorts),
                    n_perm=plan.n_perm)
    return meta, t


_SENTINEL = np.int32(np.iinfo(np.int32).max)


def plan_to_scatter_arrays(plan: DaspPlan, dtype: str) -> Tuple[PlanMeta, Dict]:
    """Lower a plan for the scatter executor (``spmv_scatter_fn``).

    Adds ``seg_pos``: one int32 position array per segment output (in
    ``_segment_outputs`` order), padding slots set to INT32_MAX so scatter
    ``mode="drop"`` discards them.  ``inv_perm`` entries that point at the
    dummy slot (zero rows) become INT32_MAX, clamping onto the always-zero
    trailing slot of the (n_perm+1)-sized scatter buffer.
    """
    meta, t = plan_to_arrays(plan, dtype)
    order = plan.order_rid
    pos = 0

    def seg(capacity: int) -> np.ndarray:
        nonlocal pos
        p = np.arange(pos, pos + capacity, dtype=np.int64)
        p = np.where(order[pos:pos + capacity] >= 0, p, _SENTINEL)
        pos += capacity
        return p.astype(np.int32)

    if plan.long is not None:
        t["long"]["pos"] = [seg(b.shape[0]) for b in plan.long.buckets]
    for g, gt in zip(plan.sell, t["sell"]):
        gt["pos"] = seg(g.vals.shape[0] * g.vals.shape[2])
    if plan.pair13 is not None:
        t["pair13"]["pos1"] = seg(plan.pair13.pairs_capacity)
        t["pair13"]["pos3"] = seg(plan.pair13.pairs_capacity)
    for s, st in zip(plan.shorts, t["shorts"]):
        st["pos"] = seg(s.rows_capacity)

    dummy = plan.n_perm - 1
    inv = plan.inv_perm.astype(np.int64)
    t["inv_perm"] = np.where(inv == dummy, _SENTINEL, inv).astype(np.int32)
    t["remainder"] = [dict(r, pos=np.where(r["pos"] == dummy, _SENTINEL,
                                           r["pos"]).astype(np.int32))
                      for r in t["remainder"]]
    return meta, t


# --- value algebra: one executor body covers f32/bf16 and dd-f64 ----------


def _pairwise_sum(a, axis: int):
    """Sum along ``axis`` by a halving tree (zero-padded to a power of two).

    The pairwise order bounds the f32 rounding error by ~eps * log2(n) of
    the row's absolute mass.  ``jnp.sum`` leaves the order to XLA, which on
    the GPU was measured at twice the error on long cancelling rows
    (livejournal_like f32: 4.2e-5 vs 2.1e-5 of max(|y|, 1)), and past the
    1e-5 golden check on wikitalk_like over four devices."""
    n = a.shape[axis]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, p - n)
        a = jnp.pad(a, pad)
    while a.shape[axis] > 1:
        h = a.shape[axis] // 2
        a = (jax.lax.slice_in_dim(a, 0, h, axis=axis)
             + jax.lax.slice_in_dim(a, h, 2 * h, axis=axis))
    return jnp.squeeze(a, axis)


class _Alg:
    """Scalar algebra over a single float array."""

    def __init__(self, dtype: str):
        self.dtype = dtype
        self.acc = jnp.float32

    def gather_x(self, x, cols):
        return x[cols]

    def mul(self, vals, xg):
        # in f32, where a bf16 x bf16 product is exact.  Rounding products
        # to bf16 before the sum costs up to 2^-9 of a row's absolute mass:
        # on the GPU that missed the 0.05 bf16 check on cancelling rows
        # (wikitalk_like 0.21, uniform_medium 0.056 of max(|y|, 1))
        return vals.astype(self.acc) * xg.astype(self.acc)

    def sum(self, prod, axis):
        return _pairwise_sum(prod, axis)

    def reshape(self, prod, shape):
        return prod.reshape(shape)

    def index(self, prod, idx):
        return prod[idx]

    def zeros(self, shape):
        return jnp.zeros(shape, self.acc)

    def concat(self, parts):
        return jnp.concatenate(parts)

    def scatter(self, buf, pos, vals):
        return buf.at[pos].add(vals, mode="drop")

    def combine(self, primary, scattered):
        return primary + scattered

    def take(self, y, idx):
        return jnp.take(y, idx, mode="clip")

    def finalize(self, y):
        if self.dtype == BF16:
            return y.astype(jnp.bfloat16)
        return y


class _DDAlg:
    """Double-double algebra: values are (hi, lo) dict pairs."""

    dtype = F64

    def gather_x(self, x, cols):
        return dict(hi=x["hi"][cols], lo=x["lo"][cols])

    def mul(self, vals, xg):
        h, l = dd.mul(vals["hi"], vals["lo"], xg["hi"], xg["lo"])
        return dict(hi=h, lo=l)

    def sum(self, prod, axis):
        h, l = dd.sum_axis(prod["hi"], prod["lo"], axis)
        return dict(hi=h, lo=l)

    def reshape(self, prod, shape):
        return dict(hi=prod["hi"].reshape(shape), lo=prod["lo"].reshape(shape))

    def index(self, prod, idx):
        return dict(hi=prod["hi"][idx], lo=prod["lo"][idx])

    def zeros(self, shape):
        z = jnp.zeros(shape, jnp.float32)
        return dict(hi=z, lo=z)

    def concat(self, parts):
        return dict(hi=jnp.concatenate([p["hi"] for p in parts]),
                    lo=jnp.concatenate([p["lo"] for p in parts]))

    def scatter(self, buf, pos, vals):
        return dict(hi=buf["hi"].at[pos].add(vals["hi"], mode="drop"),
                    lo=buf["lo"].at[pos].add(vals["lo"], mode="drop"))

    def combine(self, primary, scattered):
        h, l = dd.add(primary["hi"], primary["lo"],
                      scattered["hi"], scattered["lo"])
        return dict(hi=h, lo=l)

    def take(self, y, idx):
        return dict(hi=jnp.take(y["hi"], idx, mode="clip"),
                    lo=jnp.take(y["lo"], idx, mode="clip"))

    def finalize(self, y):
        return y


def _alg_for(dtype: str):
    return _DDAlg() if dtype == F64 else _Alg(dtype)


def _segment_outputs(alg, meta: PlanMeta, arrays: Dict, x):
    """Yield the flat output of every packed structure, in y_perm layout
    order: [long buckets... | sell groups... | pair13 y1 | pair13 y3 |
    shorts...].  Each yielded value is a flat array (or hi/lo dict)."""
    long = arrays["long"]
    if long is not None:
        xg = alg.gather_x(x, long["cols"])
        partial = alg.sum(alg.mul(long["vals"], xg), 1)      # (C,)
        zero = alg.zeros((1,))
        padded = alg.concat([partial, zero])                 # (C+1,)
        for idx in long["buckets"]:
            per_row = alg.index(padded, idx)                 # (R_b, 2^k)
            yield alg.sum(per_row, 1)

    for g in arrays["sell"]:
        xg = alg.gather_x(x, g["cols"])
        s = alg.sum(alg.mul(g["vals"], xg), 1)               # (S, 128)
        yield alg.reshape(s, (-1,))

    p13 = arrays["pair13"]
    if p13 is not None:
        xg = alg.gather_x(x, p13["cols"])
        prod = alg.mul(p13["vals"], xg)                      # (T, 8, 128)
        T = p13["cols"].shape[0]
        prod = alg.reshape(prod, (T, 2, 4, 128))
        y1 = alg.index(prod, (slice(None), slice(None), 0))
        y3 = alg.sum(alg.index(
            prod, (slice(None), slice(None), slice(1, 4))), 2)
        yield alg.reshape(y1, (-1,))
        yield alg.reshape(y3, (-1,))

    for s, st in zip(arrays["shorts"], meta.strides):
        xg = alg.gather_x(x, s["cols"])
        prod = alg.mul(s["vals"], xg)                        # (T, 8, 128)
        T = s["cols"].shape[0]
        prod = alg.reshape(prod, (T, 8 // st, st, 128))
        yield alg.reshape(alg.sum(prod, 2), (-1,))


def _remainder_into(alg, meta: PlanMeta, arrays: Dict, x, y_perm):
    """Scatter-add the spilled-tail contributions into y_perm."""
    if not arrays["remainder"]:
        return y_perm
    scattered = alg.zeros((meta.n_perm,))
    for g in arrays["remainder"]:
        xg = alg.gather_x(x, g["cols"])
        r = alg.sum(alg.mul(g["vals"], xg), 1)               # (S, 128)
        scattered = alg.scatter(scattered, g["pos"], alg.reshape(r, (-1,)))
    return alg.combine(y_perm, scattered)


def spmv_fn(meta: PlanMeta, arrays: Dict, x):
    """The jittable SpMV: packed arrays pytree + x -> y (original row order).

    ``x`` is a (n_cols,) array of the plan dtype, or a {"hi","lo"} pair of
    float32 arrays for the dd-f64 path.  Returns (n_rows,) in the accumulate
    dtype (f32; bf16 output for the bf16 path; hi/lo pair for f64).
    """
    alg = _alg_for(meta.dtype)
    parts = list(_segment_outputs(alg, meta, arrays, x))
    parts.append(alg.zeros((1,)))                            # dummy slot
    y_perm = alg.concat(parts)
    y_perm = _remainder_into(alg, meta, arrays, x, y_perm)
    y = alg.take(y_perm, arrays["inv_perm"])
    return alg.finalize(y)


def spmv_scatter_fn(meta: PlanMeta, arrays: Dict, x):
    """Scatter-based executor variant used by the multi-chip path.

    Instead of concatenating segment outputs (whose offsets would differ per
    chip once arrays are zero-padded to a common shape signature), every
    structure scatter-adds its flat output at its own ``pos`` array (pad
    slots = INT32_MAX, which ``mode="drop"`` discards).  The y_perm buffer
    gets one extra trailing slot that is never written; padded/zero-row
    ``inv_perm`` entries are INT32_MAX and clamp onto it via the clipped
    final take.
    """
    alg = _alg_for(meta.dtype)
    y_perm = alg.zeros((meta.n_perm + 1,))
    pos_list = []
    long = arrays["long"]
    if long is not None:
        pos_list.extend(long["pos"])
    pos_list.extend(g["pos"] for g in arrays["sell"])
    if arrays["pair13"] is not None:
        pos_list.append(arrays["pair13"]["pos1"])
        pos_list.append(arrays["pair13"]["pos3"])
    pos_list.extend(s["pos"] for s in arrays["shorts"])
    for out, pos in zip(_segment_outputs(alg, meta, arrays, x), pos_list):
        # segment pos ranges are disjoint and land on zero slots, so the
        # component-wise scatter-add is EXACT even for dd hi/lo pairs
        y_perm = alg.scatter(y_perm, pos, out)
    y_perm = _remainder_scatter(alg, meta, arrays, x, y_perm)
    y = alg.take(y_perm, arrays["inv_perm"])
    return alg.finalize(y)


def _remainder_scatter(alg, meta: PlanMeta, arrays: Dict, x, y_perm):
    """Remainder tails COLLIDE with segment outputs (same row positions),
    so for dd they must not be component-added into y_perm (hi+hi rounds
    and the carry is lost => ~1e-7).  Mirror ``_remainder_into``: scatter
    into a separate zero buffer (exact except tail-vs-tail collisions,
    whose error is ~2^-24 of the small tails), then one renormalizing
    ``combine`` (dd.add) against y_perm — restoring full dd accuracy on
    the multi-chip executor path."""
    if not arrays["remainder"]:
        return y_perm
    scattered = alg.zeros((meta.n_perm + 1,))
    for g in arrays["remainder"]:
        xg = alg.gather_x(x, g["cols"])
        r = alg.sum(alg.mul(g["vals"], xg), 1)
        scattered = alg.scatter(scattered, g["pos"], alg.reshape(r, (-1,)))
    return alg.combine(y_perm, scattered)


def perturb_x(x, y):
    """Fold an (numerically negligible) function of y back into x[0] so a
    timing loop's iterations form a true data-dependence chain that XLA
    cannot hoist or fold (the perturbation is ~1e-36 relative).  Only one
    element changes, in place, so the loop adds no pass over x."""
    tap_src = y["hi"] if isinstance(y, dict) else y
    tap = tap_src.ravel()[0].astype(jnp.float32) * jnp.float32(1e-36)
    if isinstance(x, dict):
        return dict(hi=x["hi"].at[0].add(tap), lo=x["lo"])
    return x.at[0].add(tap.astype(x.dtype))
