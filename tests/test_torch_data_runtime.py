"""The port's data pipeline and runtime (``repro_torch.data``,
``repro_torch.runtime``): the reference's ``tests/test_runtime.py`` on the
port's classes, and the synthetic corpus bit for bit equal to the
reference's ``repro.data.SyntheticCorpus``."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticCorpus as JSyntheticCorpus
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.oracle import FixedOracle
from repro_torch.data import DataConfig, PrefetchLoader, SyntheticCorpus
from repro_torch.runtime import (ElasticMesh, HeartbeatBoard, HotSparePool,
                                 StragglerMonitor)


# --------------------------------------------------------------------------
# the corpus against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [
    dict(vocab_size=128_256, seq_len=2048, global_batch=4),
    dict(vocab_size=256, seq_len=64, global_batch=8, host_count=2,
         host_id=1, seed=7),
    dict(vocab_size=50, seq_len=5, global_batch=3, pack_docs=False),
], ids=["llama-size", "host-shard", "no-packing"])
def test_corpus_batches_bit_equal_to_the_reference(kw):
    ours, ref = SyntheticCorpus(DataConfig(**kw)), \
        JSyntheticCorpus(JDataConfig(**kw))
    for step in (0, 1, 17, 123):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# heartbeat / straggler
# --------------------------------------------------------------------------
def test_heartbeat_all_ready():
    board = HeartbeatBoard(4)
    mon = StragglerMonitor(board, dead_after_s=5.0)
    for h in range(4):
        board.beat(h, 7)
    rep = mon.wait_for_step(7, timeout_s=1.0)
    assert sorted(rep.ready) == [0, 1, 2, 3]
    assert not rep.failed and not rep.stragglers


def test_heartbeat_detects_straggler_and_failure():
    board = HeartbeatBoard(4)
    mon = StragglerMonitor(board, dead_after_s=0.2, lag_steps=2)
    for h in (0, 1):
        board.beat(h, 10)
    stop = threading.Event()

    def slow_host():                            # alive, stuck at step 4
        while not stop.is_set():
            board.beat(2, 4)
            time.sleep(0.02)

    t = threading.Thread(target=slow_host)
    t.start()
    try:
        rep = mon.wait_for_step(10, timeout_s=0.5)   # host 3 never beats
    finally:
        stop.set()
        t.join(timeout=5.0)
    assert not t.is_alive()
    assert 3 in rep.failed                     # silent host presumed dead
    assert 2 in rep.stragglers                 # alive but behind the median


def test_heartbeat_concurrent_beats():
    """More beating threads than cores, switching often: every host's last
    step survives (a lost update under the lock would lower one)."""
    board = HeartbeatBoard(16)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def beat(h):
            for s in range(50):
                board.beat(h, s)

        ts = [threading.Thread(target=beat, args=(h,)) for h in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    snap = board.snapshot()
    assert all(p.last_step == 49 for p in snap.values())


def test_heartbeat_mark_failed_and_recover():
    board = HeartbeatBoard(2)
    board.beat(0, 3)
    board.beat(1, 3)
    board.mark_failed(1)
    rep = StragglerMonitor(board).wait_for_step(3, timeout_s=0.2)
    assert rep.failed == [1] and rep.ready == [0]
    board.beat(1, 3)                            # a beat clears the failure
    assert not board.snapshot()[1].failed


# --------------------------------------------------------------------------
# elastic re-mesh
# --------------------------------------------------------------------------
def test_elastic_plan_full_and_degraded():
    em = ElasticMesh(chips_per_host=4, model_axis=16, global_batch=256)
    full = em.plan(64)                      # 64 hosts * 4 = 256 chips
    assert full.shape == (16, 16)
    assert full.axis_names == ("data", "model")
    assert full.hosts_idle == 0
    degraded = em.plan(61)
    assert degraded.model == 16
    assert degraded.data == 8 and 256 % degraded.data == 0
    assert degraded.hosts_used <= 61
    assert em.accum_for(degraded) == 2


def test_elastic_too_few_hosts_raises():
    em = ElasticMesh(chips_per_host=4, model_axis=16)
    with pytest.raises(ValueError):
        em.plan(2)


def test_elastic_restore_across_meshes(tmp_path):
    """A checkpoint's leaves do not depend on the mesh: it restores into
    the same template whatever the plan."""
    params = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
              "b": torch.ones((8,), dtype=torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(5, params)
    step, restored = mgr.restore(params)
    assert step == 5
    np.testing.assert_array_equal(restored["w"], params["w"].numpy())
    np.testing.assert_array_equal(restored["b"].astype(np.float32),
                                  np.ones(8, np.float32))


# --------------------------------------------------------------------------
# hot-spare pool (the paper's window over standby hosts)
# --------------------------------------------------------------------------
def test_hot_spares_mask_failures_and_adapt():
    pool = HotSparePool(max_spares=8, initial=1, hot_spinup_s=30,
                        cold_spinup_s=600)
    assert pool.on_failure() == 30
    before = pool.window.sws
    assert pool.on_failure() == 600
    assert pool.window.sws >= min(8, 2 * before)
    pool.on_spare_ready(pool.cold_queue)
    assert pool.on_failure() == 30
    st = pool.stats
    assert st.failures == 3 and st.exposed == 1 and st.masked == 2


def test_hot_spares_shrink_when_quiet():
    pool = HotSparePool(max_spares=8, initial=4)
    pool.on_spare_ready(8)
    for _ in range(25):
        pool.on_spare_ready(8)
        pool.on_failure()
    assert pool.window.sws < 4


def test_hot_spares_static_zero_always_exposed():
    pool = HotSparePool(max_spares=8, initial=0, oracle=FixedOracle())
    for _ in range(3):
        assert pool.on_failure() == 600
    assert pool.stats.exposed == 3


def test_hot_spares_tick_counts_reserved_capacity():
    pool = HotSparePool(max_spares=4, initial=2)
    pool.tick(10.0)
    assert pool.stats.hot_host_seconds == 20.0


# --------------------------------------------------------------------------
# data pipeline determinism + self-tuning depth
# --------------------------------------------------------------------------
def test_corpus_sharding_partition():
    d0 = DataConfig(vocab_size=100, seq_len=8, global_batch=8,
                    host_count=2, host_id=0)
    d1 = DataConfig(vocab_size=100, seq_len=8, global_batch=8,
                    host_count=2, host_id=1)
    b0 = SyntheticCorpus(d0).batch_at(3)
    b1 = SyntheticCorpus(d1).batch_at(3)
    assert b0["tokens"].shape == (4, 8)
    assert not np.array_equal(b0["tokens"], b1["tokens"])
    again = SyntheticCorpus(d0).batch_at(3)
    np.testing.assert_array_equal(b0["tokens"], again["tokens"])


def test_prefetch_loader_under_slow_producer():
    corpus = SyntheticCorpus(DataConfig(vocab_size=50, seq_len=4,
                                        global_batch=2))
    loader = PrefetchLoader(corpus, workers=1, produce_cost_s=2e-3,
                            initial_depth=1, max_depth=8)
    try:
        for i in range(12):
            b = loader.get()
            assert b["tokens"].shape == (2, 4)
            np.testing.assert_array_equal(b["tokens"],
                                          corpus.batch_at(i)["tokens"])
        assert loader.window.sws >= 1
        assert loader.stats["gets"] == 12
    finally:
        loader.close()
    assert not any(w.is_alive() for w in loader.workers)


@pytest.mark.parametrize("kind", ["mutable", "ttas", "sleep"])
def test_prefetch_loader_delivers_in_order_with_many_workers(kind):
    """Six producers racing for claims under the given lock: every batch
    arrives once, in order."""
    corpus = SyntheticCorpus(DataConfig(vocab_size=97, seq_len=3,
                                        global_batch=2))
    loader = PrefetchLoader(corpus, workers=6, max_depth=4,
                            lock_kind=kind)
    try:
        for i in range(40):
            np.testing.assert_array_equal(loader.get()["labels"],
                                          corpus.batch_at(i)["labels"])
    finally:
        loader.close()
    assert loader.next_consume == 40
