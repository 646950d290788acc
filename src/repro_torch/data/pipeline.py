"""Data pipeline: sharded synthetic corpus + background prefetch threads.

The port of ``repro/data/pipeline.py``, on the port's own
:class:`~repro_torch.core.mutlock.MutableLock`, ``MutableWait`` and
:class:`~repro_torch.core.window.SpinningWindow`.  Batches are numpy
arrays, bit for bit the reference's; the train loop moves them to the
device.

This is one of the host-side subsystems that uses the paper's lock directly
(DESIGN.md §3.1).  Producers tokenize/pack batches on worker threads and
push into a bounded buffer; the trainer thread pops.  The buffer is guarded
by a :class:`~repro_torch.core.mutlock.MutableLock` — handoffs are µs-scale when
the buffer is warm (spin pays off) and ms-scale when producers hit (possibly
slow, GIL-releasing) sources (sleep pays off): exactly the mixed regime the
mutable lock self-tunes for.  The *depth* of the prefetch buffer is itself a
spinning window: prefetched batches are "hot spinners" (RAM resident, zero
latency), a trainer arriving at an empty buffer is a "late wake-up" that
doubles the target depth, K clean gets shrink it by 1.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core import MutableLock, MutableWait
from repro_torch.core.window import SpinningWindow


# --------------------------------------------------------------------------
# Deterministic synthetic corpus, shardable by (host, worker)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    host_count: int = 1
    host_id: int = 0
    seed: int = 0
    pack_docs: bool = True      # emulate doc packing with EOS resets
    eos_id: int = 1


class SyntheticCorpus:
    """Deterministic per-(shard, step) token batches — same stream on every
    re-run/restart, so checkpoint-resume is reproducible bit-for-bit."""

    def __init__(self, dcfg: DataConfig):
        self.dcfg = dcfg
        assert dcfg.global_batch % dcfg.host_count == 0
        self.local_batch = dcfg.global_batch // dcfg.host_count

    def batch_at(self, step: int) -> dict:
        d = self.dcfg
        rng = np.random.default_rng(
            np.random.SeedSequence([d.seed, d.host_id, step]))
        toks = rng.integers(2, d.vocab_size,
                            size=(self.local_batch, d.seq_len + 1),
                            dtype=np.int32)
        if d.pack_docs:
            # sprinkle EOS to emulate packed document boundaries
            doc_mask = rng.random((self.local_batch, d.seq_len + 1)) < 1 / 512
            toks = np.where(doc_mask, d.eos_id, toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# --------------------------------------------------------------------------
# Prefetching loader
# --------------------------------------------------------------------------
class PrefetchLoader:
    """Bounded prefetch buffer with MutableLock'd handoff and window-tuned
    depth.

    ``get()`` blocks (MutableWait hybrid spin/sleep) until a batch is ready.
    """

    def __init__(self, corpus: SyntheticCorpus, workers: int = 2,
                 max_depth: int = 16, initial_depth: int = 2,
                 produce_cost_s: float = 0.0, lock_kind: str = "mutable"):
        from repro_torch.core import make_lock
        self.corpus = corpus
        self.lock = make_lock(lock_kind) if lock_kind != "mutable" \
            else MutableLock(max_sws=4, record_stats=True)
        self.window = SpinningWindow(max_size=max_depth,
                                     initial=initial_depth)
        self.buf: dict[int, dict] = {}
        self.next_produce = 0
        self.next_consume = 0
        self.produce_cost_s = produce_cost_s
        self._stop = threading.Event()
        self._wait = MutableWait(max_spin_s=2e-3, sleep_s=1e-4)
        self.stats = {"gets": 0, "empty_gets": 0}
        self.workers = [threading.Thread(target=self._worker, daemon=True)
                        for _ in range(workers)]
        for w in self.workers:
            w.start()

    # -- producer side --------------------------------------------------------
    def _worker(self) -> None:
        while not self._stop.is_set():
            with self.lock:
                depth = len(self.buf)
                target = self.window.sws
                if depth >= target:
                    claim = None
                else:
                    claim = self.next_produce
                    self.next_produce += 1
            if claim is None:
                time.sleep(1e-4)
                continue
            if self.produce_cost_s:
                time.sleep(self.produce_cost_s)
            batch = self.corpus.batch_at(claim)
            with self.lock:
                self.buf[claim] = batch

    # -- consumer side --------------------------------------------------------
    def get(self) -> dict:
        self.stats["gets"] += 1
        step = self.next_consume
        with self.lock:
            hit = step in self.buf
        if not hit:
            self.stats["empty_gets"] += 1
        # window observation: empty buffer on arrival == late wake-up
        self.window.observe(late_wake=not hit,
                            occupancy=len(self.buf) + 1)
        ok = self._wait.wait(lambda: self._peek(step), timeout_s=30.0)
        if not ok:
            raise TimeoutError(f"batch {step} never arrived")
        with self.lock:
            batch = self.buf.pop(step)
        self.next_consume += 1
        return batch

    def _peek(self, step: int) -> bool:
        with self.lock:
            return step in self.buf

    def close(self) -> None:
        self._stop.set()
        for w in self.workers:
            w.join(timeout=2.0)
