#!/usr/bin/env python
"""DASP benchmark CLI.

Runs the packed SpMV on the benchmark suite on the available device,
against the jax.experimental.sparse BCOO baseline (the role cuSPARSE plays
in ``main_f64.cu:19-100``), with the reference's warmup+timed protocol
(``dasp_f64.h:1285-1286``).

Prints a summary JSON line
  {"metric": "spmv_gflops_geomean", "value": <geomean dasp GFLOP/s over the
   suite x {f32, bf16, f64}>, "unit": "GFLOP/s",
   "vs_baseline": <geomean speedup of dasp-f32 over BCOO-f32>,
   "device": {"platform", "kind", "count"}, "power_limit": <nvidia-smi>}
INCREMENTALLY: the running summary is re-printed after every completed
(matrix, dtype) arm, and when run as a script a SIGTERM/SIGALRM/SIGINT
handler prints the final summary before exiting, so a timeout kill still
leaves a complete record of everything measured so far (the last JSON
line on stdout is always the most complete one).

Arm ordering is DTYPE-MAJOR: every matrix at f32 (cheapest nnz first),
then every matrix at bf16, then f64 — so a wall-budget kill costs the
least-important tail.  The BCOO competitor runs after every dasp arm is
recorded and back-fills the baseline columns of the CSV rows.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

import numpy as np

# CUDA numbers the cards as nvidia-smi does, so the power limit recorded is
# that of the card measured (bench.device.smi_id)
os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")


class _Summary:
    """Running suite summary; emitted after every arm and from the signal
    handlers so a killed run still ends with a JSON line."""

    def __init__(self):
        self.gflops = []
        self.ratios = []
        self.done = 0
        self.total = 0
        self.device = None

    def line(self) -> str:
        from dasp_tpu.bench import geomean
        dev = self.device or {}
        return json.dumps({
            "metric": "spmv_gflops_geomean",
            "value": round(geomean(self.gflops), 3),
            "unit": "GFLOP/s",
            "vs_baseline": round(geomean(self.ratios), 3)
            if self.ratios else 0.0,
            "arms_done": self.done, "arms_total": self.total,
            "device": {"platform": dev.get("platform"),
                       "kind": dev.get("device_kind"),
                       "count": dev.get("count")},
            "power_limit": dev.get("power_limit")})

    def emit(self) -> None:
        if self.gflops:
            print(self.line(), flush=True)


SUMMARY = _Summary()


def _install_handlers(deadline: float) -> None:
    def die(signum, frame):
        SUMMARY.emit()
        sys.stdout.flush()
        os._exit(0)

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, die)
    if deadline > 0:
        signal.signal(signal.SIGALRM, die)
        signal.alarm(int(deadline))


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="small suite + few iters (smoke test)")
    ap.add_argument("--dtypes", default="f32,bf16,f64")
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--names", default=None,
                    help="comma-separated suite subset")
    ap.add_argument("--csv-dir", default="data")
    ap.add_argument("--deadline", type=float,
                    default=float(os.environ.get("DASP_BENCH_DEADLINE",
                                                 3600)),
                    help="self-imposed wall budget (s) when run as a "
                         "script; the summary is printed and the process "
                         "exits 0 when it fires (0 disables)")
    # The reference's tunables were argv[2]/argv[3] before being hardcoded
    # (main_f64.cu:121-125); expose them so they can be swept.
    ap.add_argument("--block-longest", type=int, default=None,
                    help="long-row threshold (reference default 256)")
    ap.add_argument("--threshold", type=float, default=None,
                    help="SELL occupancy target (reference default 0.75)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of one timing loop "
                         "per arm into DIR (the reference ships -lineinfo "
                         "for nsight, Makefile:10)")
    ap.add_argument("--mtx", nargs="*", default=None,
                    help="benchmark these .mtx files instead of the suite")
    ap.add_argument("--multichip", action="store_true",
                    help="bench the row-partitioned multi-device operator "
                         "over all local devices (skips with a note on a "
                         "single device)")
    return ap


def main(argv=None) -> int:
    """Run the benchmark in-process (no signal handlers are installed)."""
    return run(_parser().parse_args(argv))


def run(args) -> int:
    import jax
    from dasp_tpu import SpMVOperator, load_matrix
    from dasp_tpu.bench import (BCOOBaseline, append_record, bench_spmv,
                                build_suite, record_from, update_baseline)
    from dasp_tpu.bench.device import describe
    from dasp_tpu.config import DEFAULT_CONFIG
    from dasp_tpu.utils import enable_compile_cache

    enable_compile_cache()

    config = DEFAULT_CONFIG
    overrides = {k: v for k, v in [
        ("block_longest", args.block_longest),
        ("threshold", args.threshold)] if v is not None}
    if overrides:
        import dataclasses
        config = dataclasses.replace(config, **overrides)

    device = describe()
    SUMMARY.device = device
    tag = f"[{device['device_kind']}, {device['power_limit'] or 'no limit'}]"
    print(f"# devices: {jax.devices()} {tag}", file=sys.stderr)
    warmup = args.warmup if args.warmup is not None else (10 if args.quick
                                                          else 100)
    # 100 timed iterations: the timing loop grows the count until one
    # call is long enough, so the reference's 1000 (dasp_f64.h:1286) is
    # not needed for stable numbers.
    iters = args.iters if args.iters is not None else (50 if args.quick
                                                       else 100)
    dtypes = args.dtypes.split(",")

    if args.mtx:
        suite = [(p.rsplit("/", 1)[-1], load_matrix(p)) for p in args.mtx]
    else:
        names = args.names.split(",") if args.names else None
        if args.quick and not names:
            names = ["cop20k_like", "wikitalk_like"]
        suite = build_suite(names)
    # Cheapest arms first: a wall-budget kill then costs the least data.
    suite.sort(key=lambda t: t[1].nnz)

    if args.multichip:
        # Row-partitioned multi-device timing (reference has no analog —
        # this is the new distributed dimension, SURVEY.md §5): each
        # device owns row strips, x replicates via all_gather.
        n_dev = len(jax.devices())
        if n_dev < 2:
            print(f"# --multichip: {n_dev} device visible, skipping",
                  file=sys.stderr)
            print(json.dumps({"metric": "spmv_multichip_geomean",
                              "value": 0.0, "unit": "GFLOP/s",
                              "vs_baseline": 0.0, "skipped": True}))
            return 0
        from dasp_tpu.parallel import MultiChipSpMV
        SUMMARY.total = len(suite) * len(dtypes)
        for dtype in dtypes:
            for name, csr in suite:
                x = np.random.default_rng(1).standard_normal(csr.n_cols)
                op = MultiChipSpMV(csr, dtype=dtype, config=config)
                res = bench_spmv(op, x, dtype, warmup=warmup, iters=iters)
                SUMMARY.gflops.append(res.gflops)
                SUMMARY.done += 1
                print(f"# {name} {dtype} x{n_dev}: {res.gflops:.2f} "
                      f"GFLOP/s ({res.seconds_per_iter*1e6:.1f} us/iter, "
                      f"balance {op.stats['balance']:.2f}) {tag}",
                      file=sys.stderr)
                SUMMARY.emit()
        return 0

    SUMMARY.total = len(suite) * len(dtypes)
    xs = {name: np.random.default_rng(1).standard_normal(csr.n_cols)
          for name, csr in suite}
    dasp_f32 = {}            # name -> dasp f32 GFLOP/s (for the ratios)

    for dtype in dtypes:
        # f32/bf16 run cheapest-first (a kill costs the least data); the
        # LAST dtype pass runs most-expensive-first instead, so the
        # priciest arm does not sit at the very end of the whole suite
        # while the small arms it displaces finish in seconds.
        ordered = (suite if dtype != dtypes[-1]
                   else sorted(suite, key=lambda t: -t[1].nnz))
        for name, csr in ordered:
            op = SpMVOperator(csr, dtype=dtype, config=config)
            op.plan.stats["pack_seconds"] = op.pack_seconds
            if args.profile:
                import jax.profiler
                with jax.profiler.trace(args.profile):
                    jax.block_until_ready(
                        op.timing_loop(8)(op._prep_x(xs[name])))
            res = bench_spmv(op, xs[name], dtype, warmup=warmup,
                             iters=iters)
            SUMMARY.gflops.append(res.gflops)
            SUMMARY.done += 1
            if dtype == "f32":
                dasp_f32[name] = res.gflops
            append_record(f"{args.csv_dir}/spmv_{dtype}_record.csv",
                          record_from(op.plan, res, name, dtype, device))
            print(f"# {name} {dtype}: {res.gflops:.2f} GFLOP/s "
                  f"({res.seconds_per_iter*1e6:.1f} us/iter, "
                  f"bw {res.bandwidth1_gbs:.1f} GB/s model1, "
                  f"compile {res.compile_seconds:.1f}s) {tag}",
                  file=sys.stderr)
            SUMMARY.emit()
            del op

    # The BCOO competitor runs PER DTYPE (the reference runs cuSPARSE in
    # both its binaries, main_f64.cu:65-86 / main_f16.cu:57-58): f32 and
    # bf16 natively; the f64 arm reuses the f32 measurement (the f64 path
    # runs as double-double without JAX's 64-bit mode, so BCOO has no f64
    # to run in) and the CSV's baseline_dtype column records that.  It
    # runs after every dasp arm is recorded, so a competitor failure or a
    # deadline loses no dasp row, and back-fills the rows' baseline
    # columns.  Results persist in <csv-dir>/baseline_cache.json keyed by
    # device kind, so a number is only ever replayed on the device it was
    # measured on.
    cache_path = f"{args.csv_dir}/baseline_cache.json"
    try:
        with open(cache_path) as f:
            cache = json.load(f)
    except (OSError, ValueError):
        cache = {}
    from dasp_tpu.bench.harness import BenchResult
    for dtype in dtypes:
        bdt = "f32" if dtype == "f64" else dtype
        for name, csr in suite:
            key = f"{device['device_kind']}|{name}|{bdt}|{csr.nnz}"
            if key in cache:
                base = BenchResult(**cache[key])
            else:
                try:
                    base = bench_spmv(BCOOBaseline(csr, bdt), xs[name], bdt,
                                      iters=min(iters, 10), trials=2)
                except Exception as e:   # the baseline may be unsupported
                    print(f"# BCOO baseline failed on {name} {bdt}: {e!r}",
                          file=sys.stderr)
                    continue
                cache[key] = base.as_dict()
                os.makedirs(args.csv_dir, exist_ok=True)
                with open(cache_path, "w") as f:
                    json.dump(cache, f, indent=1)
            update_baseline(f"{args.csv_dir}/spmv_{dtype}_record.csv",
                            name, device["device_kind"], base, bdt)
            if dtype == "f32" and name in dasp_f32:
                SUMMARY.ratios.append(dasp_f32[name] / base.gflops)
            print(f"# {name} BCOO {bdt}: {base.gflops:.2f} GFLOP/s {tag}",
                  file=sys.stderr)
            SUMMARY.emit()
    return 0


if __name__ == "__main__":
    _args = _parser().parse_args()
    _install_handlers(_args.deadline)
    sys.exit(run(_args))
