"""Smoke for the port's streaming sweep engine: bounded-memory proof.

The port of ``benchmarks/stream_smoke.py``.  Runs a 20k-config discipline
sweep through :func:`repro_torch.core.stream.sweep_stream` (through the
kernel; ``--device cpu``: its plain version on the host) under a
deliberately SMALL memory budget (default 16 MiB, forcing many chunks)
and asserts, in order:

* the chunk plan respects the budget — ``chunk_size x bytes_per_config``
  fits the resolved budget (or the plan bottomed out at one group);
* the run actually streamed (``n_chunks > 1`` at this scale);
* peak-RSS growth over the run (``resource.getrusage`` high-water mark,
  snapshotted after a small warmup that builds the kernels) stays under
  ``--rss-ceiling-mb``;
* on the card, the device's counterpart: the growth of
  ``torch.cuda.max_memory_allocated`` over the bytes allocated after the
  warmup stays within the resolved budget, the footprint the planner's
  :func:`~repro_torch.core.stream.bytes_per_config` promises.

Exit status is the contract: 0 = streamed within budget, 1 = any assert
failed.

    PYTHONPATH=src python -m repro_torch.bench.stream_smoke \\
        [--configs 20000] [--mem-mb 16] [--rss-ceiling-mb 512] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import resource
import time

import torch

from repro_torch.device import resolve_device


def _maxrss_mb() -> float:
    # ru_maxrss is KiB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", type=int, default=20_000)
    ap.add_argument("--target-cs", type=int, default=20)
    ap.add_argument("--mem-mb", type=float, default=16.0,
                    help="streaming budget — small on purpose, so the "
                         "20k sweep MUST chunk")
    ap.add_argument("--rss-ceiling-mb", type=float, default=512.0,
                    help="max allowed peak-RSS growth over the streamed "
                         "run (measured from the post-warmup high-water "
                         "mark)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain "
                         "versions on the host")
    args = ap.parse_args(argv)

    from repro_torch.configs.catalog import (lock_discipline_columns,
                                             lock_discipline_variants)
    from repro_torch.core import stream as xstream

    on_card = resolve_device(args.device).type == "cuda"
    kw = dict(backend="kernel", bucket_steps=True, mem_mb=args.mem_mb,
              device=args.device)
    V = len(lock_discipline_variants())
    n_scenarios = max(1, args.configs // V)
    C = n_scenarios * V

    # Warmup: touch the whole path at toy scale (the reference's 8
    # scenarios and target_cs 5, or the run's own when smaller) so the
    # kernel build and the allocator's pools land in the baselines, not
    # the measured growth.
    xstream.sweep_stream(
        lock_discipline_columns(n_scenarios=min(8, n_scenarios)),
        target_cs=min(5, args.target_cs), **kw)
    cols = lock_discipline_columns(n_scenarios=n_scenarios)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dev0 = torch.cuda.memory_allocated()
    rss0 = _maxrss_mb()

    t0 = time.perf_counter()
    res = xstream.sweep_stream(cols, target_cs=args.target_cs, **kw)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rss1 = _maxrss_mb()
    grown = rss1 - rss0
    dev_grown = (torch.cuda.max_memory_allocated() - dev0) if on_card \
        else None

    budget_bytes = res.budget_mb * (1 << 20)
    chunk_bytes = res.chunk_size * res.bytes_per_config
    print(f"stream smoke: {C} configs in {res.n_chunks} chunk(s) of "
          f"<= {res.chunk_size} ({wall:.1f}s, {C / wall:.0f} cfg/s); "
          f"chunk footprint {chunk_bytes / 2**20:.1f} MB of "
          f"{res.budget_mb:.0f} MB budget; peak RSS {rss1:.0f} MB "
          f"(+{grown:.0f} MB over warmup baseline, ceiling "
          f"{args.rss_ceiling_mb:.0f} MB)"
          + (f"; device +{dev_grown / 2**20:.2f} MB over warmup"
             if on_card else ""))

    failures = []
    # a plan may exceed a too-small budget only when floored at one group
    if chunk_bytes > budget_bytes and res.chunk_size > V:
        failures.append(f"chunk plan over budget: {chunk_bytes} B > "
                        f"{budget_bytes:.0f} B")
    if res.n_chunks <= 1:
        failures.append(f"did not stream: {res.n_chunks} chunk at "
                        f"C={C}, budget {args.mem_mb} MB")
    if grown > args.rss_ceiling_mb:
        failures.append(f"peak RSS grew {grown:.0f} MB > ceiling "
                        f"{args.rss_ceiling_mb:.0f} MB")
    if on_card and dev_grown > max(budget_bytes, chunk_bytes):
        failures.append(f"device memory grew {dev_grown} B > the budget "
                        f"{budget_bytes:.0f} B")
    if failures:
        for line in failures:
            print(f"FAIL: {line}")
        raise SystemExit(1)
    print("stream smoke: OK")
    return {"n_configs": C, "n_chunks": res.n_chunks,
            "chunk_size": res.chunk_size, "wall_s": wall,
            "rss_grown_mb": grown, "budget_mb": res.budget_mb,
            "chunk_mb": chunk_bytes / 2**20,
            "device_grown_mb": (dev_grown / 2**20 if on_card else None)}


if __name__ == "__main__":
    main()
