"""Benchmark harness: the reference's measurement protocol.

Timing mirrors ``dasp_f64.h:1285-1398``: N warmup iterations, M timed
iterations bracketed by full device synchronization (``block_until_ready``
playing the role of ``cudaDeviceSynchronize``), throughput = ``2*nnz/time``
GFLOP/s with padding FLOPs excluded (``dasp_f64.h:1395``), plus the two
bandwidth models (``dasp_f64.h:1162-1172``):
  * model 1: A values + column ids once, x and y once each;
  * model 2: same but x counted once per nonzero.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict

import jax

# Reference protocol (dasp_f64.h:1285-1286); override for quick runs.
WARMUP = 100
ITERS = 1000


@dataclasses.dataclass
class BenchResult:
    seconds_per_iter: float
    gflops: float
    bandwidth1_gbs: float
    bandwidth2_gbs: float
    preprocess_seconds: float = 0.0
    # relative max-min range of the per-trial differenced timings
    # (drift diagnostic; the CSV records it as dasp_spread)
    spread: float = 0.0
    # iteration count the adaptive loop actually timed with
    timed_iters: int = 0
    # wall time of the first (compiling) timing-loop call — kept apart
    # from the host pack time (the reference's f16 preprocessing metric is
    # host pack alone, dasp_f16.h:1021,1444-1446; its CUDA kernels are
    # compiled ahead of time, ours once per plan shape)
    compile_seconds: float = 0.0

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def _val_bytes(dtype: str) -> int:
    return {"f32": 4, "bf16": 2, "f64": 8}[dtype]


def data_models(n_rows: int, n_cols: int, nnz: int, dtype: str):
    """The two data-volume models of ``dasp_f64.h:1162-1172`` (bytes)."""
    vb = _val_bytes(dtype)
    ib = 4
    data1 = nnz * (vb + ib) + (n_rows + n_cols) * vb
    data2 = nnz * (vb + ib + vb) + n_rows * vb
    return data1, data2


def _sync(out) -> None:
    """Wait for every device buffer of ``out`` (``cudaDeviceSynchronize``'s
    role in the reference)."""
    jax.block_until_ready(out)


# One timed call runs at least this long, so the call's own launch and
# synchronization cost is a small share of it; the loop length grows
# until it does, up to MAX_LOOP_ITERS.
MIN_CALL_SECONDS = 0.05
MAX_LOOP_ITERS = 200_000


def _time_loop_stats(op, x_dev, iters: int = ITERS, trials: int = 3):
    """Seconds per SpMV using the operator's in-jit timing loop: one call
    runs ``n + 1`` chained iterations on device (the reference's
    100-warmup/1000-iter protocol, dasp_f64.h:1285-1286).

    The first call compiles; its wall is returned as ``compile_s``.  The
    loop length starts at ``iters`` and grows until one call lasts at
    least MIN_CALL_SECONDS (the iteration count is a runtime scalar, so
    this costs no recompile).  Then ``trials`` calls are timed.  Returns
    ``(seconds_per_iter, spread, n, compile_s)``: the median call over
    ``n + 1``, and the relative max-min range of the trials."""
    n = max(iters, 1)
    loop = op.timing_loop(n)
    t0 = time.perf_counter()
    _sync(loop(x_dev))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _sync(loop(x_dev))
    wall = time.perf_counter() - t0
    if wall < MIN_CALL_SECONDS and n < MAX_LOOP_ITERS:
        n = int(min(math.ceil(1.2 * n * MIN_CALL_SECONDS / max(wall, 1e-9)),
                    MAX_LOOP_ITERS))
        loop = op.timing_loop(n)
        _sync(loop(x_dev))
    walls = []
    for _ in range(trials):
        t0 = time.perf_counter()
        _sync(loop(x_dev))
        walls.append(time.perf_counter() - t0)
    walls.sort()
    med = walls[len(walls) // 2]
    spread = (walls[-1] - walls[0]) / med if med > 0 else 0.0
    return med / (n + 1), spread, n, compile_s


def bench_spmv(op, x, dtype: str, warmup: int = WARMUP,
               iters: int = ITERS, trials: int = 3) -> BenchResult:
    """Benchmark an SpMVOperator (or any object with .timing_loop, ._prep_x,
    .n_rows/.n_cols/.nnz)."""
    del warmup  # the in-jit loop needs no separate warmup phase
    x_dev = op._prep_x(x)
    sec, spread, n, compile_s = _time_loop_stats(op, x_dev, iters, trials)
    d1, d2 = data_models(op.n_rows, op.n_cols, op.nnz, dtype)
    return BenchResult(
        seconds_per_iter=sec,
        gflops=2.0 * op.nnz / sec / 1e9,
        bandwidth1_gbs=d1 / sec / 1e9,
        bandwidth2_gbs=d2 / sec / 1e9,
        preprocess_seconds=getattr(op, "preprocess_seconds", 0.0),
        spread=spread, timed_iters=n, compile_seconds=compile_s)
