"""Quickstart: the whole stack in a minute.

The port of ``examples/quickstart.py``:

1. a MutableLock protecting a shared counter (the paper's primitive),
2. the DES reproducing the paper's Fig. 1 claim,
3. a tiny llama training for a few steps (optimizer + data),
4. greedy decoding through the window-scheduled serving engine.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Parts 1 and 2 run on the host; parts 3 and 4 on the card (K5 and K8 on
every layer) unless ``--device cpu`` (the plain PyTorch versions).  The
train step runs eagerly, where the reference jits it.
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.configs import base as cbase
from repro_torch.configs.catalog import tiny
from repro_torch.configs.inputs import concrete_batch
from repro_torch.core import MutableLock
from repro_torch.core.des import simulate
from repro_torch.device import resolve_device
from repro_torch.serve import ContinuousBatcher, DecodeEngine, Request
from repro_torch.train import TrainConfig, init_state, make_train_step

TRAIN_STEPS = 8
REQUESTS = 6


def lock_counter(threads: int = 4, per_thread: int = 500) -> int:
    """Part 1: ``threads`` threads each add ``per_thread`` to a counter
    under one MutableLock; returns the count."""
    lock = MutableLock(max_sws=4, record_stats=True)
    counter = [0]

    def bump(n):
        for _ in range(n):
            with lock:
                counter[0] += 1

    ts = [threading.Thread(target=bump, args=(per_thread,))
          for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert counter[0] == threads * per_thread
    print(f"[lock] {threads} threads x {per_thread} increments -> "
          f"{counter[0]} (sleeps={lock.stats.sleeps}, late wake-ups="
          f"{lock.stats.late_wakeups}, final sws={lock.sws})")
    return counter[0]


def fig1_slots() -> dict:
    """Part 2: slots (of one CS) the DES takes for 3 CSes under each lock
    (the paper: spin 3, sleep 5, mutable 3)."""
    unit = 10e-6
    res = {}
    for kind, kw in (("ttas", {}), ("sleep", {}),
                     ("mutable", {"initial_sws": 2})):
        r = simulate(kind, threads=3, cores=3, cs=(unit, unit),
                     ncs=(1e-9, 1e-9), wake_latency=unit, target_cs=3,
                     max_cs_per_thread=1, seed=1, lock_kwargs=kw)
        res[kind] = r.t_end / unit
    print(f"[fig1] slots for 3 CSes — spin {res['ttas']:.1f}, "
          f"sleep {res['sleep']:.1f}, mutable {res['mutable']:.1f} "
          f"(paper: 3 / 5 / 3)")
    return res


def train_tiny(device):
    """Part 3: TRAIN_STEPS steps of tiny llama on one 4 x 32 batch:
    (cfg, state, losses)."""
    cfg = tiny(cbase.get_config("llama3.2-1b"))
    tcfg = TrainConfig(warmup_steps=5, decay_steps=50)
    state = init_state(cfg, tcfg,
                       torch.Generator(device=device).manual_seed(0), device)
    step = make_train_step(cfg, tcfg)
    batch = concrete_batch(cfg, 4, 32,
                           torch.Generator(device=device).manual_seed(1))
    t0 = time.time()
    losses = []
    for _ in range(TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    print(f"[train] tiny llama3.2: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"in {TRAIN_STEPS} steps ({time.time() - t0:.1f}s)")
    return cfg, state, losses


def serve_tiny(cfg, params, device) -> dict:
    """Part 4: REQUESTS greedy requests through the engine and the
    batcher; returns the stats summary."""
    engine = DecodeEngine(cfg, params, max_slots=3, max_seq=32,
                          device=device)
    bat = ContinuousBatcher(engine, initial=1)
    rng = np.random.default_rng(0)
    for i in range(REQUESTS):
        bat.submit(Request(rid=i, prompt=list(rng.integers(2, 200, 5)),
                           max_new_tokens=6))
    stats = bat.run_until_drained(max_steps=300).summary()
    print(f"[serve] {stats['completed']} requests, late-handoff rate "
          f"{stats['late_handoff_rate']:.2f}, avg standby "
          f"{stats['avg_standby']:.2f}")
    return stats


def main(argv=None) -> dict:
    """All four parts; returns ``{"counter", "fig1", "losses",
    "serve"}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu, for parts 3 and 4")
    device = resolve_device(ap.parse_args(argv).device)
    counter = lock_counter()
    fig1 = fig1_slots()
    cfg, state, losses = train_tiny(device)
    serve = serve_tiny(cfg, state["params"], device)
    print("quickstart OK")
    return {"counter": counter, "fig1": fig1, "losses": losses,
            "serve": serve}


if __name__ == "__main__":
    main()
