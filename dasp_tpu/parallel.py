"""Multi-device SpMV: row-strip partitioning over a 1-D device mesh.

This capability is *new* relative to the reference (which is strictly
single-GPU, SURVEY.md §2): rows are partitioned into nnz-balanced strips
dealt to devices, each device owns its strips' packed plan, x is sharded
by rows and replicated on every device via ``jax.lax.all_gather`` over the
mesh axis, and y needs no communication at all (a row partition makes
outputs disjoint).

Each device runs the scatter form of the XLA executor
(``xla_backend.spmv_scatter_fn``).  ``_harmonize`` pads the per-device
lowered arrays to elementwise-max shapes (padded value tiles are zero and
contribute nothing; padded position entries are INT32_MAX, which the
scatter drops) so ``shard_map`` traces one program over the stacked
arrays.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .config import DaspConfig, DEFAULT_CONFIG
from .plan import build_plan
from .sparse import CSRMatrix
from .ops import dd
from .ops.xla_backend import (F64, PlanMeta, _SENTINEL, perturb_x,
                              plan_to_scatter_arrays, spmv_scatter_fn)


def partition_rows(csr: CSRMatrix, n_parts: int) -> List[Tuple[int, int]]:
    """Contiguous row ranges with approximately equal nnz per part."""
    targets = np.linspace(0, csr.nnz, n_parts + 1)
    bounds = np.searchsorted(csr.row_ptr, targets, side="left")
    bounds[0], bounds[-1] = 0, csr.n_rows
    bounds = np.maximum.accumulate(bounds)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n_parts)]


def slab_csr(csr: CSRMatrix, start: int, end: int) -> CSRMatrix:
    """Extract rows [start, end) as a standalone CSR (full column space)."""
    lo, hi = int(csr.row_ptr[start]), int(csr.row_ptr[end])
    return CSRMatrix(end - start, csr.n_cols,
                     (csr.row_ptr[start:end + 1] - lo).copy(),
                     csr.col_idx[lo:hi].copy(), csr.values[lo:hi].copy())


def partition_strips(csr: CSRMatrix, n_parts: int, align: int,
                     strips_per_part: int = 8
                     ) -> Tuple[List[List[Tuple[int, int]]], List[int]]:
    """Strip-interleaved row partition: ``n_parts * strips_per_part``
    nnz-balanced contiguous strips, each a whole multiple of ``align``
    rows, dealt to devices by greedy longest-processing-time assignment.

    Contiguous slabs of a skewed (power-law) matrix give every device a
    structurally DIFFERENT sub-matrix (hub rows cluster), so per-device
    packers pick different widths and classes and ``_harmonize``'s
    elementwise-max union pads every device for every other device's
    shapes.  Strips sample the whole row space ~uniformly: each device
    sees a statistically similar class mix, and LPT yields a tighter nnz
    balance than contiguous splitting as a bonus.

    Returns (per-device sorted strip lists, per-device nnz loads)."""
    raw = partition_rows(csr, n_parts * strips_per_part)
    bounds = [0]
    for _, e in raw[:-1]:
        bounds.append(min(-(-e // align) * align, csr.n_rows))
    bounds.append(csr.n_rows)
    bounds = sorted(set(bounds))
    ranges = [(bounds[i], bounds[i + 1]) for i in range(len(bounds) - 1)]
    nnz_of = [int(csr.row_ptr[e] - csr.row_ptr[s]) for s, e in ranges]
    # Two-dimensional balance: long-row mass sets each device's long
    # stream, which _harmonize pads to the cross-device max, so balance
    # both nnz and long-row mass with a greedy min of the worse
    # normalized load.
    lens = csr.row_lengths.astype(np.int64)
    LONG_LEN = 1024
    lmass = np.where(lens >= LONG_LEN, lens, 0)
    lcum = np.concatenate([[0], np.cumsum(lmass)])
    long_of = [int(lcum[e] - lcum[s]) for s, e in ranges]
    avg_n = max(sum(nnz_of) / n_parts, 1.0)
    avg_l = max(sum(long_of) / n_parts, 1.0)
    order = sorted(range(len(ranges)),
                   key=lambda i: (long_of[i], nnz_of[i]), reverse=True)
    loads = [0] * n_parts
    lloads = [0] * n_parts
    assign: List[List[Tuple[int, int]]] = [[] for _ in range(n_parts)]
    for i in order:
        c = min(range(n_parts),
                key=lambda c: max((loads[c] + nnz_of[i]) / avg_n,
                                  (lloads[c] + long_of[i]) / avg_l))
        assign[c].append(ranges[i])
        loads[c] += nnz_of[i]
        lloads[c] += long_of[i]
    for strips in assign:
        strips.sort()
    return assign, loads


def strips_csr(csr: CSRMatrix, strips: List[Tuple[int, int]]) -> CSRMatrix:
    """Concatenate the given row ranges into one standalone CSR (rows in
    strip order; full column space).  An empty strip list yields an
    empty 0-row matrix (``_harmonize`` pads such devices)."""
    if not strips:
        return CSRMatrix(0, csr.n_cols, np.zeros(1, csr.row_ptr.dtype),
                         csr.col_idx[:0].copy(), csr.values[:0].copy())
    lens = np.concatenate([csr.row_lengths[s:e] for s, e in strips])
    cols = np.concatenate([csr.col_idx[csr.row_ptr[s]:csr.row_ptr[e]]
                           for s, e in strips])
    vals = np.concatenate([csr.values[csr.row_ptr[s]:csr.row_ptr[e]]
                           for s, e in strips])
    rpt = np.zeros(lens.size + 1, dtype=csr.row_ptr.dtype)
    np.cumsum(lens, out=rpt[1:])
    return CSRMatrix(int(lens.size), csr.n_cols, rpt, cols, vals)


def _pad_to(a: np.ndarray, shape, fill) -> np.ndarray:
    pads = [(0, t - s) for s, t in zip(a.shape, shape)]
    if not any(p[1] for p in pads):
        return a
    return np.pad(a, pads, constant_values=fill)


def _harmonize(metas: List[PlanMeta], ts: List[dict]) -> Tuple[PlanMeta, dict]:
    """Zero/sentinel-pad per-chip lowered plans to one shape signature and
    stack each leaf on a leading device axis."""
    dtype = metas[0].dtype
    n_perm = max(m.n_perm for m in metas)

    def z_vals(shape):
        if dtype == F64:
            return dict(hi=np.zeros(shape, np.float32),
                        lo=np.zeros(shape, np.float32))
        return np.zeros(shape,
                        ml_dtypes.bfloat16 if dtype == "bf16" else np.float32)

    def vals_shape(v):
        return v["hi"].shape if isinstance(v, dict) else v.shape

    def pad_vals(v, shape):
        if isinstance(v, dict):
            return dict(hi=_pad_to(v["hi"], shape, 0),
                        lo=_pad_to(v["lo"], shape, 0))
        return _pad_to(v, shape, 0)

    # ---- shorts: union of strides, canonical (4, 2, 1) order ----
    strides = tuple(s for s in (4, 2, 1)
                    if any(s in m.strides for m in metas))
    shorts_by_chip = []
    for m, t in zip(metas, ts):
        by_stride = dict(zip(m.strides, t["shorts"]))
        shorts_by_chip.append(by_stride)
    new_shorts: List[List[dict]] = [[] for _ in ts]
    for s in strides:
        t_max = max(vals_shape(c[s]["vals"])[0] if s in c else 0
                    for c in shorts_by_chip)
        shape = (t_max, 8, 128)
        cap = t_max * (8 // s) * 128
        for i, c in enumerate(shorts_by_chip):
            if s in c:
                e = c[s]
                new_shorts[i].append(dict(
                    vals=pad_vals(e["vals"], shape),
                    cols=_pad_to(e["cols"], shape, 0),
                    pos=_pad_to(e["pos"], (cap,), _SENTINEL)))
            else:
                new_shorts[i].append(dict(
                    vals=z_vals(shape), cols=np.zeros(shape, np.int32),
                    pos=np.full((cap,), _SENTINEL, np.int32)))

    # ---- pair13 ----
    has_p13 = any(t["pair13"] is not None for t in ts)
    new_p13: List[Optional[dict]] = []
    if has_p13:
        t_max = max(vals_shape(t["pair13"]["vals"])[0]
                    for t in ts if t["pair13"] is not None)
        shape = (t_max, 8, 128)
        cap = t_max * 2 * 128
        for t in ts:
            p = t["pair13"]
            if p is not None:
                new_p13.append(dict(
                    vals=pad_vals(p["vals"], shape),
                    cols=_pad_to(p["cols"], shape, 0),
                    pos1=_pad_to(p["pos1"], (cap,), _SENTINEL),
                    pos3=_pad_to(p["pos3"], (cap,), _SENTINEL)))
            else:
                new_p13.append(dict(
                    vals=z_vals(shape), cols=np.zeros(shape, np.int32),
                    pos1=np.full((cap,), _SENTINEL, np.int32),
                    pos3=np.full((cap,), _SENTINEL, np.int32)))
    else:
        new_p13 = [None] * len(ts)

    # ---- sell / remainder groups: match by width ----
    def harmonize_groups(key, with_pos_key):
        widths = sorted({vals_shape(g["vals"])[1]
                         for t in ts for g in t[key]})
        out: List[List[dict]] = [[] for _ in ts]
        for w in widths:
            s_max = max(
                sum(vals_shape(g["vals"])[0] for g in t[key]
                    if vals_shape(g["vals"])[1] == w) for t in ts)
            if s_max == 0:
                continue
            shape = (s_max, w, 128)
            cap = s_max * 128
            for i, t in enumerate(ts):
                match = [g for g in t[key] if vals_shape(g["vals"])[1] == w]
                if match:
                    g = match[0]
                    out[i].append(dict(
                        vals=pad_vals(g["vals"], shape),
                        cols=_pad_to(g["cols"], shape, 0),
                        pos=_pad_to(g[with_pos_key].reshape(-1), (cap,),
                                    _SENTINEL)))
                else:
                    out[i].append(dict(
                        vals=z_vals(shape), cols=np.zeros(shape, np.int32),
                        pos=np.full((cap,), _SENTINEL, np.int32)))
        return out

    new_sell = harmonize_groups("sell", "pos")
    new_rem = harmonize_groups("remainder", "pos")

    # ---- long stream: match buckets by width 2^k ----
    has_long = any(t["long"] is not None for t in ts)
    new_long: List[Optional[dict]] = []
    if has_long:
        c_max = max(t["long"]["cols"].shape[0]
                    for t in ts if t["long"] is not None)
        chunk = next(t["long"]["cols"].shape[1]
                     for t in ts if t["long"] is not None)
        bwidths = sorted({b.shape[1] for t in ts if t["long"] is not None
                          for b in t["long"]["buckets"]})
        r_max = {w: max((b.shape[0]
                         for t in ts if t["long"] is not None
                         for b in t["long"]["buckets"] if b.shape[1] == w),
                        default=0) for w in bwidths}
        vshape = (c_max, chunk)
        for t in ts:
            lt = t["long"]
            buckets, poss = [], []
            for w in bwidths:
                match = ([(b, p) for b, p in zip(lt["buckets"], lt["pos"])
                          if b.shape[1] == w] if lt is not None else [])
                if match:
                    b, p = match[0]
                    buckets.append(_pad_to(b, (r_max[w], w), _SENTINEL))
                    poss.append(_pad_to(p, (r_max[w],), _SENTINEL))
                else:
                    buckets.append(np.full((r_max[w], w), _SENTINEL, np.int32))
                    poss.append(np.full((r_max[w],), _SENTINEL, np.int32))
            if lt is not None:
                new_long.append(dict(vals=pad_vals(lt["vals"], vshape),
                                     cols=_pad_to(lt["cols"], vshape, 0),
                                     buckets=buckets, pos=poss))
            else:
                new_long.append(dict(vals=z_vals(vshape),
                                     cols=np.zeros(vshape, np.int32),
                                     buckets=buckets, pos=poss))
    else:
        new_long = [None] * len(ts)

    rows_max = max(t["inv_perm"].shape[0] for t in ts)
    new_ts = []
    for i, t in enumerate(ts):
        new_ts.append(dict(
            shorts=new_shorts[i], pair13=new_p13[i], sell=new_sell[i],
            remainder=new_rem[i], long=new_long[i],
            inv_perm=_pad_to(t["inv_perm"], (rows_max,), _SENTINEL)))
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *new_ts)
    meta = PlanMeta(dtype=dtype, strides=strides, n_perm=n_perm)
    return meta, stacked


class MultiChipSpMV:
    """Row-partitioned SpMV over a 1-D mesh: y_strips = A_strips @ allgather(x).

    Args:
      csr: the full matrix.
      devices: list of jax devices (defaults to all).
      dtype: "f32" / "bf16" / "f64".
      config: packing tunables.

    ``stats`` records the per-device nnz balance (``slab_nnz``, and
    ``balance`` = max/mean).
    """

    def __init__(self, csr: CSRMatrix, devices=None, dtype: str = "f32",
                 config: DaspConfig = DEFAULT_CONFIG):
        devices = devices if devices is not None else jax.devices()
        self.n_devices = len(devices)
        self.mesh = Mesh(np.array(devices), ("x",))
        self.dtype = dtype
        self.n_rows, self.n_cols = csr.n_rows, csr.n_cols
        self.nnz = csr.nnz
        self.stats = {}

        # strip-interleaved partition: every device's sub-matrix samples
        # the whole row space, so per-device packers see similar class
        # mixes and the harmonized union pads far less than contiguous
        # slabs on skewed inputs (see partition_strips)
        self.strips, slab_nnz = partition_strips(csr, self.n_devices,
                                                 config.slice_rows)
        self.stats["slab_nnz"] = slab_nnz
        self.stats["balance"] = (max(slab_nnz)
                                 / max(sum(slab_nnz) / len(slab_nnz), 1.0))

        metas, ts = [], []
        for strips in self.strips:
            plan = build_plan(strips_csr(csr, strips), config)
            m, t = plan_to_scatter_arrays(plan, self.dtype)
            metas.append(m)
            ts.append(t)
        self.meta, stacked = _harmonize(metas, ts)
        self._x_total = -(-self.n_cols // self.n_devices) * self.n_devices
        meta = self.meta

        def step(arrays, x_sharded):
            # x arrives row-sharded; replicate it on every device — the
            # only communication in the whole SpMV.
            x_full = jax.tree.map(
                lambda a: jax.lax.all_gather(a, "x", tiled=True), x_sharded)
            local = jax.tree.map(lambda a: a[0], arrays)
            y = spmv_scatter_fn(meta, local, x_full)
            if meta.dtype == F64:
                return jnp.stack([y["hi"], y["lo"]])[None]
            return y[None]

        self._step = jax.jit(jax.shard_map(
            step, mesh=self.mesh, in_specs=(P("x"), P("x")),
            out_specs=P("x"), check_vma=False))
        self._x_sharding = NamedSharding(self.mesh, P("x"))
        self._arrays = jax.device_put(stacked, self._x_sharding)

    def _prep_x(self, x):
        xp = np.zeros(self._x_total, dtype=np.float64)
        xp[:self.n_cols] = np.asarray(x)[:self.n_cols]
        if self.dtype == F64:
            hi, lo = dd.from_f64(xp)
            return jax.device_put(dict(hi=hi, lo=lo), self._x_sharding)
        want = ml_dtypes.bfloat16 if self.dtype == "bf16" else np.float32
        return jax.device_put(xp.astype(want), self._x_sharding)

    def __call__(self, x) -> np.ndarray:
        y = np.asarray(jax.device_get(
            self._step(self._arrays, self._prep_x(x))), dtype=np.float64)
        out = np.zeros(self.n_rows, dtype=np.float64)
        for d, strips in enumerate(self.strips):
            part = y[d, 0] + y[d, 1] if self.dtype == F64 else y[d]
            off = 0
            for start, end in strips:
                out[start:end] = part[off:off + end - start]
                off += end - start
        return out

    def timing_loop(self, iters: int):
        """Jitted loop of ``iters + 1`` chained steps (bench --multichip):
        the same contract as ``SpMVOperator.timing_loop``."""
        step = self._step
        loop = getattr(self, "_loop_jit", None)
        if loop is None:
            @jax.jit
            def loop(arrays, x, it):
                def body(_, x):
                    return perturb_x(x, step(arrays, x))
                x = jax.lax.fori_loop(0, it, body, x)
                return step(arrays, x)
            self._loop_jit = loop
        it = jnp.int32(iters)
        return lambda x_dev: loop(self._arrays, x_dev, it)
