"""CSV recorder replicating the reference's per-matrix record schema
(``dasp_f64.h:1438-1442``; f16 variant with preprocessing time,
``dasp_f16.h:1755-1759``).  One row is appended per benchmarked matrix to
``data/spmv_<dtype>_record.csv``."""

from __future__ import annotations

import os
from typing import Dict

FIELDS = [
    # the device every number of the row was measured on: JAX's
    # device_kind and the card's power limit as nvidia-smi reports it
    "device_kind", "power_limit",
    "filename", "rowA", "colA", "nnzA",
    "short_row_1", "common_13", "short_row_3", "short_row_4", "short_row_2",
    "row_long", "row_block",
    "nnz_short", "fill0_nnz_short", "nnz_long", "fill0_nnz_long",
    "origin_nnz_reg", "fill0_nnz_reg", "nnz_irreg",
    "rate_fill0", "block_longest", "data_X",
    # dasp_pre keeps the reference's combined semantics (full standalone
    # pack + operator setup); pack_seconds is the host pack wall alone
    # (the reference's f16 preprocessing metric, dasp_f16.h:1444-1446)
    # and compile_seconds the first call of the timed loop
    "dasp_pre", "pack_seconds", "compile_seconds",
    "dasp_time", "dasp_gflops",
    "dasp_bandwidth1", "dasp_bandwidth2",
    # relative max-min range of the timed trials + the iteration count
    # the timing loop settled on
    "dasp_spread", "timed_iters",
    # baseline_dtype records what the BCOO competitor actually computed
    # in: f32/bf16 natively; the f64 arm reuses the f32 competitor (the
    # f64 path runs as double-double without JAX's 64-bit mode)
    "baseline_dtype", "baseline_time", "baseline_gflops",
    # baseline setup wall (ms): BCOO construction + upload — the analog
    # of the cuSPARSE preprocessing wall the reference records
    # (main_f64.cu:48-63)
    "baseline_pre",
]


def append_record(path: str, row: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = ",".join(FIELDS)
    if os.path.exists(path):
        with open(path) as f:
            old = f.readline().rstrip("\n")
        if old != header:          # schema changed: rotate the old file
            n = 1
            while os.path.exists(f"{path}.v{n}"):
                n += 1
            os.rename(path, f"{path}.v{n}")
    new = not os.path.exists(path)
    with open(path, "a") as f:
        if new:
            f.write(header + "\n")
        f.write(",".join(str(row.get(k, "")) for k in FIELDS) + "\n")


def update_baseline(path: str, filename: str, device_kind: str, baseline,
                    baseline_dtype: str) -> None:
    """Back-fill the baseline columns of the rows for ``filename`` measured
    on ``device_kind``.

    Refuses (ValueError) a file whose header is not ``FIELDS``: its cells
    would be written by the wrong column order."""
    if not os.path.exists(path):
        return
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        return
    if lines[0] != ",".join(FIELDS):
        raise ValueError(f"{path}: header differs from the record schema")
    idx = {k: i for i, k in enumerate(FIELDS)}
    out = [lines[0]]
    for line in lines[1:]:
        cells = line.split(",")
        if (len(cells) == len(FIELDS) and cells[idx["filename"]] == filename
                and cells[idx["device_kind"]] == device_kind):
            cells[idx["baseline_dtype"]] = baseline_dtype
            cells[idx["baseline_time"]] = str(
                round(baseline.seconds_per_iter * 1e3, 6))
            cells[idx["baseline_gflops"]] = str(round(baseline.gflops, 3))
            cells[idx["baseline_pre"]] = str(
                round(baseline.preprocess_seconds * 1e3, 3))
            line = ",".join(cells)
        out.append(line)
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


def record_from(plan, result, name: str, dtype: str, device: Dict,
                baseline=None, baseline_dtype: str = "") -> Dict:
    """One CSV row; ``device`` is ``bench.device.describe()``."""
    from .harness import data_models
    data1, _ = data_models(plan.n_rows, plan.n_cols, plan.nnz, dtype)
    c = plan.census
    row = dict(
        device_kind=device["device_kind"],
        power_limit=device["power_limit"],
        filename=name, rowA=plan.n_rows, colA=plan.n_cols, nnzA=plan.nnz,
        short_row_1=c.get("short_row_1", 0), common_13=c.get("common_13", 0),
        short_row_3=c.get("short_row_3", 0),
        short_row_4=c.get("short_row_4", 0),
        short_row_2=c.get("short_row_2", 0),
        row_long=c.get("row_long", 0), row_block=c.get("row_block", 0),
        nnz_short=c.get("nnz_short", 0), nnz_long=c.get("nnz_long", 0),
        fill0_nnz_short=int(plan.stats.get("fill0_nnz_short", 0)),
        fill0_nnz_long=int(plan.stats.get("fill0_nnz_long", 0)),
        origin_nnz_reg=int(plan.stats.get("origin_nnz_reg", 0)),
        fill0_nnz_reg=int(plan.stats.get("fill0_nnz_reg", 0)),
        nnz_irreg=int(plan.stats.get("nnz_irreg", 0)),
        rate_fill0=round(plan.stats.get("rate_fill0", 0.0), 4),
        block_longest=plan.config.block_longest,
        data_X=data1,
        dasp_pre=round(result.preprocess_seconds * 1e3, 3),
        pack_seconds=round(float(plan.stats.get("pack_seconds", 0.0)), 3),
        compile_seconds=round(result.compile_seconds, 3),
        dasp_time=round(result.seconds_per_iter * 1e3, 6),
        dasp_gflops=round(result.gflops, 3),
        dasp_bandwidth1=round(result.bandwidth1_gbs, 3),
        dasp_bandwidth2=round(result.bandwidth2_gbs, 3),
        dasp_spread=round(result.spread, 4),
        timed_iters=result.timed_iters,
    )
    if baseline is not None:
        row["baseline_dtype"] = baseline_dtype or dtype
        row["baseline_time"] = round(baseline.seconds_per_iter * 1e3, 6)
        row["baseline_gflops"] = round(baseline.gflops, 3)
        row["baseline_pre"] = round(baseline.preprocess_seconds * 1e3, 3)
    return row
