"""PHOLD on a share-everything PDES (paper Fig. 4), with REAL locks — the
port's copy of ``benchmarks/phold.py`` on the port's threaded locks
(:func:`repro_torch.core.make_lock`).  Host threads only: it does not touch
the card.

The paper runs PHOLD on their share-everything Parallel Discrete Event
Simulator: worker threads repeatedly grab the next event, lock the target
Logical Process (LP), process the event (a busy loop of 25/50/100 µs), and
schedule a follow-up event.  32 of 1024 LPs are hot-spots receiving 50% of
events, so LP locks contend.

Under CPython's GIL, event processing is ``time.sleep(granularity)``
instead of a busy loop — sleeping releases the GIL, so event processing
genuinely overlaps across threads and wall-clock speedup is measurable,
emulating a many-core machine.  What the lock discipline changes is how
waiters behave on contended hot-spot LPs: spin (latency), sleep (wake-up
delay on the critical path), or the mutable lock's tuned window.
``MutableLock(max_sws=20)`` mirrors the paper's "max = number of cores" on
the emulated 20-core box.

Metrics: speedup vs sequential execution of the same event count, and lock
spin-iterations (the CPU-waste proxy; exact cycle accounting is not
meaningful under the GIL).

    PYTHONPATH=src python -m repro_torch.bench.phold [--quick] \
        [--events N]
"""

from __future__ import annotations

import argparse
import heapq
import json
import os
import random
import threading
import time

from repro_torch.core import make_lock

N_LPS = 1024
N_HOT = 32
HOT_FRACTION = 0.5


class ShareEverythingPDES:
    """Minimal share-everything PDES: a global future-event list + per-LP
    locks; workers process events optimistically in timestamp order."""

    def __init__(self, lock_kind: str, n_threads: int, n_events: int,
                 granularity_s: float, seed: int = 0):
        self.n_threads = n_threads
        self.n_events = n_events
        self.granularity_s = granularity_s
        self.rng = random.Random(seed)
        kind, kw = lock_kind, {}
        if lock_kind == "mutable":            # paper: max SWS = core count
            kw = {"max_sws": 20}              # the emulated 20-core machine
        elif lock_kind == "mutable-1core":    # max = REAL cores on this box
            kind, kw = "mutable", {"max_sws": 1}
        self.lp_locks = [make_lock(kind, **kw) for _ in range(N_LPS)]
        self.fel_lock = make_lock(kind, **kw)            # future event list
        self.fel: list[tuple[float, int, int]] = []
        self.processed = 0
        self.done = threading.Event()
        for i in range(4 * n_threads):                   # initial population
            heapq.heappush(self.fel, (self.rng.random(), i, self._target()))

    def _target(self) -> int:
        if self.rng.random() < HOT_FRACTION:
            return self.rng.randrange(N_HOT)
        return self.rng.randrange(N_HOT, N_LPS)

    def _worker(self, wid: int) -> None:
        rng = random.Random(1000 + wid)
        while True:
            with self.fel_lock:
                if self.processed >= self.n_events:
                    self.done.set()
                    return
                if not self.fel:
                    continue
                ts, eid, lp = heapq.heappop(self.fel)
                self.processed += 1
                my_count = self.processed
            lock = self.lp_locks[lp]
            with lock:                       # the contended critical section
                time.sleep(self.granularity_s)   # event processing (GIL-free)
            tgt = (rng.randrange(N_HOT) if rng.random() < HOT_FRACTION
                   else rng.randrange(N_HOT, N_LPS))
            nxt = (ts + rng.expovariate(1.0), my_count * 100 + wid, tgt)
            with self.fel_lock:
                heapq.heappush(self.fel, nxt)

    def run(self) -> float:
        t0 = time.monotonic()
        ts = [threading.Thread(target=self._worker, args=(i,))
              for i in range(self.n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return time.monotonic() - t0

    def spin_iters(self) -> int:
        total = 0
        for lk in self.lp_locks + [self.fel_lock]:
            if hasattr(lk, "spin_iters"):
                total += lk.spin_iters
            elif hasattr(lk, "spn_obj"):
                pass                        # mutable: TTAS iterations not
        return total                        # individually counted


def run_phold(locks=("ttas", "sleep", "adaptive", "mutable",
               "mutable-1core"),
              n_threads=(16, 20), granularities=(25e-6, 50e-6, 100e-6),
              n_events: int = 1500, verbose: bool = True) -> dict:
    out: dict = {}
    for gran in granularities:
        seq_time = n_events * gran          # sequential = sum of all events
        gkey = f"{int(gran*1e6)}us"
        out[gkey] = {}
        for tc in n_threads:
            row = {}
            for kind in locks:
                sim = ShareEverythingPDES(kind, tc, n_events, gran)
                wall = sim.run()
                speedup = seq_time / wall
                row[kind] = {"wall_s": round(wall, 3),
                             "speedup": round(speedup, 2)}
                if verbose:
                    print(f"phold {gkey} t={tc:<3} {kind:>14}: "
                          f"speedup {speedup:6.2f} (wall {wall:.2f}s)",
                          flush=True)
            out[gkey][tc] = row
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="[legacy] PHOLD on a share-everything PDES with REAL "
                    "Python threads (paper Fig. 4).  Kept as the "
                    "wall-clock artifact; it cannot batch (real threads, "
                    "GIL).  For simulation-scale discipline comparisons "
                    "use the batched engine instead: repro_torch.bench.sweep "
                    "/ repro_torch.bench.discipline_diagram.")
    ap.add_argument("--events", type=int, default=1500)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out", default="reports/torch/phold.json")
    args = ap.parse_args(argv)
    if args.quick:
        res = run_phold(n_threads=(16,), granularities=(50e-6,),
                        n_events=min(args.events, 600))
    else:
        res = run_phold(n_events=args.events)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
