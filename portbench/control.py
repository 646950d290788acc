"""The control of the check: the reference computed in bfloat16, the
precision below the configuration's float32, put in the program's place.

    python3 -m portbench.control --workload NAME --seeds S1 S2 S3

For each seed it takes the configs the check would sample from sweep 0 of
a run with that seed, at the cell's own size, runs each over the cell's
horizon (the longest planned one under the step cap: the steps every
config of these sweeps runs, no early exit firing) in float32 and in
bfloat16, and counts the configs whose bfloat16 summary the check would
refuse (``rows_differing``; its limit is 0).  Prints one JSON line.
"""

from __future__ import annotations

import json
import sys
import time

from . import check, harness
from . import traffic as TR


def readings(config: dict, traffic: dict, seeds, workers=None,
             precision: str = "bfloat16") -> list[dict]:
    sweep = TR.build(config, traffic)
    t0 = time.perf_counter()
    per_seed, args = [], []
    for seed in seeds:
        cols = sweep.with_seed(seed, 0)
        dt, steps = TR.plan(cols, sweep.target_cs)
        n = min(int(steps.max()), TR.MAX_STEPS)
        rows = check.sample_rows(seed, sweep.n_configs, steps)
        per_seed.append((seed, n, len(rows)))
        for p in (precision, "float32"):
            args += [(TR.encode_row(cols, i, dt[i]), n, sweep.target_cs, p)
                     for i in rows]
    got = iter(check.run_rows(args, workers))
    out = []
    for seed, n, k in per_seed:
        low = [next(got) for _ in range(k)]
        ref = [next(got) for _ in range(k)]
        fields = check.SUMMARY + (check.OPEN_SUMMARY + ("lat_hist",)
                                  if "lat_hist" in ref[0] else ())
        differing = sum(not check.row_agrees({f: c[f] for f in fields}, r)
                        for c, r in zip(low, ref))
        out.append({"seed": seed, "rows_checked": k, "steps": n,
                    "rows_differing": differing})
    out.append({"seconds": time.perf_counter() - t0})
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    w, config, traffic = harness.cell_of(harness.load_spec(), a.workload)
    print(json.dumps({"workload": a.workload,
                      "control": readings(config, traffic, a.seeds)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
