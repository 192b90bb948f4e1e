"""Benchmark harness smoke tests (CPU)."""

import json

import numpy as np
import pytest

from dasp_tpu import SpMVOperator
from dasp_tpu.bench import (BCOOBaseline, append_record, bench_spmv, geomean,
                            record_from, update_baseline)
from dasp_tpu.bench.record import FIELDS
from dasp_tpu.sparse import mixed_categories

DEVICE = {"platform": "cpu", "device_kind": "cpu", "count": 1,
          "power_limit": ""}


def test_bench_protocol_runs(rng, tmp_path):
    csr = mixed_categories(300, rng)
    x = rng.standard_normal(csr.n_cols)
    op = SpMVOperator(csr, dtype="f32")
    res = bench_spmv(op, x, "f32", iters=3)
    assert res.seconds_per_iter > 0
    assert res.gflops > 0
    row = record_from(op.plan, res, "t", "f32", DEVICE)
    assert row["nnzA"] == csr.nnz
    assert row["device_kind"] == "cpu"
    p = tmp_path / "rec.csv"
    append_record(str(p), row)
    append_record(str(p), row)
    lines = p.read_text().strip().splitlines()
    assert len(lines) == 3 and lines[0] == ",".join(FIELDS)


def test_update_baseline_fills_matching_rows(rng, tmp_path):
    csr = mixed_categories(200, rng)
    op = SpMVOperator(csr, dtype="f32")
    res = bench_spmv(op, rng.standard_normal(csr.n_cols), "f32", iters=2)
    p = tmp_path / "rec.csv"
    append_record(str(p), record_from(op.plan, res, "a", "f32", DEVICE))
    other = dict(DEVICE, device_kind="other")
    append_record(str(p), record_from(op.plan, res, "a", "f32", other))
    update_baseline(str(p), "a", "cpu", res, "f32")
    rows = [dict(zip(FIELDS, ln.split(",")))
            for ln in p.read_text().splitlines()[1:]]
    assert rows[0]["baseline_dtype"] == "f32"
    assert float(rows[0]["baseline_gflops"]) > 0
    assert rows[1]["baseline_dtype"] == ""        # other device untouched


def test_update_baseline_refuses_other_schema(rng, tmp_path):
    p = tmp_path / "old.csv"
    p.write_text("filename,rowA\nx,1\n")
    with pytest.raises(ValueError, match="header"):
        update_baseline(str(p), "x", "cpu", None, "f32")


def test_bcoo_baseline_correct(rng):
    csr = mixed_categories(200, rng)
    x = rng.standard_normal(csr.n_cols)
    base = BCOOBaseline(csr, "f32")
    y = base(x)
    golden = csr.spmv(x)
    scale = np.maximum(np.abs(golden), 1.0)
    np.testing.assert_allclose(y / scale, golden / scale, rtol=2e-5,
                               atol=2e-5)


def test_geomean():
    assert abs(geomean([1.0, 4.0]) - 2.0) < 1e-12
    assert geomean([]) == 0.0


def test_cli_summary_names_device(tmp_path, capsys):
    """bench.main runs in-process and its last JSON line names the
    device; the CSV row carries the device kind."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    import dasp_tpu.bench.suite as suite
    orig = suite.SUITE["cop20k_like"]
    suite.SUITE["cop20k_like"] = lambda r: mixed_categories(400, r)
    try:
        rc = bench.main(["--quick", "--names", "cop20k_like", "--dtypes",
                         "f32", "--deadline", "0", "--iters", "2",
                         "--csv-dir", str(tmp_path)])
    finally:
        suite.SUITE["cop20k_like"] = orig
    assert rc == 0
    out = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("{")]
    last = json.loads(out[-1])
    assert last["device"]["platform"] == "cpu" and last["arms_done"] == 1
    assert last["vs_baseline"] > 0
    head, row = (tmp_path / "spmv_f32_record.csv").read_text().splitlines()
    rec = dict(zip(head.split(","), row.split(",")))
    assert rec["device_kind"] == "cpu" and rec["baseline_dtype"] == "f32"
