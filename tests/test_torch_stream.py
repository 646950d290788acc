"""The port's streamed sweep, ``repro_torch.core.stream``, on
``device="cpu"``: its chunk planner and cell reduction against the JAX
package's, streamed == one-shot (closed and open), column feed == list
feed, OOM halving, error propagation, quarantine, kill-and-resume, and the
catalog's column builders against the JAX catalog's."""

import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.configs import catalog as jcatalog
from repro.core import stream as jstream
from repro_torch.configs import catalog as tcatalog
from repro_torch.core import policy as TP
from repro_torch.core import stream as S
from repro_torch.core import xdes as txdes
from repro_torch.core.policy import SimConfig

#: Deterministic mixed batch shared — via exec — between this process and
#: the kill-and-resume subprocess, so both build the same sweep plan.
_BATCH_SRC = r"""
import numpy as np
from repro_torch.core.policy import SimConfig

def res_batch(n=24, seed=42, open_every=0):
    locks = ["ttas", "fifo", "sleep", "mutable", "adaptive", "mcs"]
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        opened = open_every and i % open_every == 0
        out.append(SimConfig(
            locks[i % 6], threads=int(rng.integers(2, 8)),
            cores=int(rng.integers(2, 8)), cs=(0.0, 3.7e-6),
            ncs=(0.0, 8e-6), wake_latency=8e-6,
            seed=int(rng.integers(0, 1000)),
            oracle=("paper", "aimd", "fixed")[i % 3],
            arrival="poisson" if opened else "closed",
            arrival_rate=float(rng.uniform(1e5, 1e6)) if opened else 0.0,
            queue_cap=int(rng.integers(2, 32))))
    return out
"""
_ns: dict = {}
exec(_BATCH_SRC, _ns)
res_batch = _ns["res_batch"]

OPEN_FIELDS = S.OPEN_SUMMARY_FIELDS + ("lat_hist",)


def _assert_summaries_equal(a, b, fields=S.SUMMARY_FIELDS, msg=""):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{msg}: {f}")


# --------------------------------------------------------------------------
# the planner and the reduction against the JAX package's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("open_loop", [False, True])
def test_bytes_per_config_and_plan_chunks_equal_reference(open_loop):
    """The memory model equals the reference's; the chunk fills the same
    budget, but as the largest multiple of the quantum rather than the
    reference's quantum x power of two, so it is never smaller."""
    for T in (1, 8, 32, 128):
        assert S.bytes_per_config(T, open_loop=open_loop) == \
            jstream.bytes_per_config(T, open_loop=open_loop)
    for C in (1, 64, 1000, 100_080):
        for T in (2, 32, 128):
            bpc = S.bytes_per_config(T, open_loop=open_loop)
            for mem_mb in (0.5, 4, 64, 512, 48_000):
                for quantum in (1, 5, 15):
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        got = S.plan_chunks(C, T, mem_mb=mem_mb,
                                            quantum=quantum,
                                            open_loop=open_loop)
                        ref = jstream.plan_chunks(C, T, mem_mb=mem_mb,
                                                  quantum=quantum,
                                                  open_loop=open_loop)
                    fit = int(mem_mb * 2**20) // bpc // quantum * quantum
                    want = min(max(fit, quantum), -(-C // quantum) * quantum)
                    assert got == want, (C, T, mem_mb, quantum)
                    assert got % quantum == 0 and got >= min(ref, want)
    with pytest.warns(UserWarning, match="quantum floor"):
        assert S.plan_chunks(100, 64, mem_mb=0.001, quantum=12) == 12
    for bad in ((0, 8), (8, 0)):
        with pytest.raises(ValueError):
            S.plan_chunks(*bad, mem_mb=1)


def test_memory_budget_priority(monkeypatch):
    """explicit > env > device > default; the device is read only when
    neither an argument nor the env var gives the budget."""
    monkeypatch.setenv(S.ENV_MEM_MB, "37")
    assert S.memory_budget_bytes() == 37 * 2**20 == \
        jstream.memory_budget_bytes()
    assert S.memory_budget_bytes(2) == 2 * 2**20
    monkeypatch.delenv(S.ENV_MEM_MB)
    assert S.memory_budget_bytes(8.5) == int(8.5 * 2**20)
    assert S.memory_budget_bytes(device="cpu") == \
        int(S.DEFAULT_MEM_MB * 2**20)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            S.memory_budget_bytes()              # None is the card


def test_cell_update_matches_reference_and_host_argmax():
    """Random throughputs with exact ties inside groups, padded groups
    masked with cell id -1: the port's scatter-add == the JAX package's
    == a host argmax fold (first maximum wins a tie)."""
    rng = np.random.default_rng(7)
    group, n_groups, n_cells = 5, 40, 3
    completed = rng.integers(1, 6, size=n_groups * group).astype(np.int32)
    t_end = np.full(n_groups * group, 0.25, np.float32)
    t_end[::7] = 0.5
    cell_ids = rng.integers(0, n_cells, size=n_groups).astype(np.int32)
    cell_ids[-3:] = -1
    wins = torch.zeros((n_cells, group), dtype=torch.int32)
    got = S._cell_update(wins, torch.from_numpy(completed),
                         torch.from_numpy(t_end), torch.from_numpy(cell_ids),
                         group=group)
    assert got is wins                               # updated in place
    want = np.asarray(jstream._cell_update(
        jnp.zeros((n_cells, group), jnp.int32), jnp.asarray(completed),
        jnp.asarray(t_end), jnp.asarray(cell_ids), group=group))
    thr = (completed.astype(np.float32) / t_end).reshape(n_groups, group)
    host = np.zeros((n_cells, group), np.int64)
    for g in range(n_groups):
        if cell_ids[g] >= 0:
            host[cell_ids[g], thr[g].argmax()] += 1
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), host)
    assert (thr == thr.max(axis=1, keepdims=True)).sum() > n_groups  # ties
    with pytest.raises(ValueError):
        S.CellReduce(group=2, cell_ids=np.asarray([0, 3]), n_cells=2)


# --------------------------------------------------------------------------
# streamed == one-shot
# --------------------------------------------------------------------------
@pytest.mark.parametrize("open_every", [0, 2])
def test_streamed_multichunk_matches_one_shot(open_every):
    """Pinned horizon, chunks of 8 with a short tail: chunk boundaries
    are invisible in every summary column, open ones included."""
    cfgs = res_batch(20, seed=3, open_every=open_every)
    one = txdes.simulate_batch(cfgs, n_steps=120, keep_per_thread=False,
                               device="cpu")
    s = S.sweep_stream(cfgs, n_steps=120, chunk=8, device="cpu")
    assert s.n_chunks == 3 and s.chunk_size == 8
    _assert_summaries_equal(s, one, msg="multi-chunk")
    if open_every:
        _assert_summaries_equal(s, one, OPEN_FIELDS, "multi-chunk open")
        assert s.departed.sum() > 0
        np.testing.assert_array_equal(s.p95, one.p95)
    else:
        assert s.lat_hist is None
    s.validate()


def test_streamed_bucketed_matches_one_shot_and_wins_match_host():
    cfgs = [SimConfig(lock, threads=3, cores=4, cs=cs, ncs=(0.0, 3.7e-6),
                      wake_latency=8e-6, seed=i)
            for i, (lock, cs) in enumerate(
                [("ttas", (0, 3.7e-6)), ("mutable", (0, 3.7e-6)),
                 ("sleep", (0, 9e-6)), ("fifo", (0, 9e-6)),
                 ("ttas", (0, 2e-5)), ("mcs", (0, 2e-5))])]
    one = txdes.simulate_batch(cfgs, target_cs=4, bucket_steps=True,
                               early_exit=False, keep_per_thread=False,
                               device="cpu")
    red = S.CellReduce(group=2, cell_ids=np.asarray([0, 1, 0]), n_cells=2)
    s = S.sweep_stream(cfgs, target_cs=4, bucket_steps=True,
                       early_exit=False, reduce=red, device="cpu")
    _assert_summaries_equal(s, one, msg="bucketed")
    thr = (s.completed.astype(np.float32)
           / np.maximum(s.t_end, np.float32(1e-30)))
    host = np.zeros((2, 2), np.int64)
    np.add.at(host, (red.cell_ids, thr.reshape(3, 2).argmax(axis=1)), 1)
    np.testing.assert_array_equal(s.wins, host)


def test_column_feed_matches_list_feed():
    """The arrival catalog as RAW columns and as SimConfig objects: the
    same plan, the same bits."""
    cols = tcatalog.lock_arrival_columns(n_scenarios=1)
    cfgs = tcatalog.lock_arrival_sweep(n_scenarios=1)
    sub = slice(0, 30)
    cols = {k: v[sub] for k, v in cols.items()}
    a = S.sweep_stream(cols, n_steps=60, chunk=15, device="cpu",
                       max_threads=32)
    b = S.sweep_stream(cfgs[sub], n_steps=60, chunk=15, device="cpu",
                       max_threads=32)
    np.testing.assert_array_equal(a.dt, b.dt)
    _assert_summaries_equal(a, b, S.SUMMARY_FIELDS + OPEN_FIELDS, "feeds")


def test_unported_and_device_paths_raise():
    cfgs = res_batch(4)
    split, whole = (S.sweep_stream(cfgs, n_steps=10, shard=shard,
                                   device="cpu") for shard in (True, False))
    _assert_summaries_equal(split, whole, S.SUMMARY_FIELDS + OPEN_FIELDS,
                            "shard=True")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            S.sweep_stream(cfgs, n_steps=10)     # device=None is the card
    red = S.CellReduce(group=4, cell_ids=np.zeros(1, np.int32), n_cells=1)
    with pytest.raises(ValueError, match="quantum"):
        S.sweep_stream(cfgs, n_steps=10, chunk=6, reduce=red, device="cpu")


# --------------------------------------------------------------------------
# self-healing
# --------------------------------------------------------------------------
def test_oom_retries_with_halved_chunks_bit_identical(monkeypatch):
    cfgs = res_batch(24, seed=7, open_every=3)
    clean = S.sweep_stream(cfgs, n_steps=100, chunk=8, device="cpu")
    real = S._run_chunk
    calls = {"n": 0, "oom": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            calls["oom"] += 1
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(*a, **kw)

    monkeypatch.setattr(S, "_run_chunk", flaky)
    with pytest.warns(UserWarning, match="halved"):
        s = S.sweep_stream(cfgs, n_steps=100, chunk=8, device="cpu")
    assert calls["oom"] == 1 and calls["n"] == 5  # 1 failed, 2 halves, 2
    _assert_summaries_equal(s, clean, S.SUMMARY_FIELDS + OPEN_FIELDS, "oom")

    def always_oom(*a, **kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(S, "_run_chunk", always_oom)
    with pytest.warns(UserWarning, match="halved"):
        with pytest.raises(torch.cuda.OutOfMemoryError):
            S.sweep_stream(cfgs[:8], n_steps=10, chunk=4, device="cpu")


@pytest.mark.parametrize("error", [
    RuntimeError("lock_sim_block launch failed: CUDA error 1"),
    RuntimeError("nvcc failed (1)"), ValueError("wrong dtype")])
def test_non_oom_error_propagates_without_halving(monkeypatch, error):
    calls = {"n": 0}

    def broken(*a, **kw):
        calls["n"] += 1
        raise error

    monkeypatch.setattr(S, "_run_chunk", broken)
    with pytest.raises(type(error), match=str(error)[:12]):
        S.sweep_stream(res_batch(8, seed=2), n_steps=10, chunk=8,
                       device="cpu")
    assert calls["n"] == 1


def test_quarantine_reports_and_sanitizes_wins(monkeypatch, tmp_path):
    cfgs = res_batch(16, seed=11)
    red = S.CellReduce(group=4, cell_ids=np.asarray([0, 1, 0, 1]), n_cells=2)
    clean = S.sweep_stream(cfgs, n_steps=90, chunk=8, reduce=red,
                           device="cpu")
    real = S._run_chunk

    def poison(*a, **kw):
        res = real(*a, **kw)
        if a[0]["seed"][0] == S.P.encode_configs(cfgs[:1])["seed"][0]:
            res["t_end"] = res["t_end"].copy()
            res["t_end"][1] = np.nan
        return res

    monkeypatch.setattr(S, "_run_chunk", poison)
    report = str(tmp_path / "failures.json")
    with pytest.warns(UserWarning, match="quarantined 1/16"):
        s = S.sweep_stream(cfgs, n_steps=90, chunk=8, reduce=red,
                           failures_path=report, device="cpu")
    assert len(s.failures) == 1 and s.failures[0]["index"] == 1
    assert "t_end" in s.failures[0]["fields"]
    assert s.failures[0]["config"]["threads"] == cfgs[1].threads
    assert np.isnan(s.t_end[1]) and os.path.exists(report)
    with pytest.raises(ValueError, match="non-finite t_end"):
        s.validate()
    # the poisoned row lost its group: the sanitized reduction moved at
    # most that group's single win
    assert s.wins.sum() == clean.wins.sum()
    assert np.abs(s.wins - clean.wins).sum() in (0, 2)


_CRASH_SCRIPT = r"""
import os
import numpy as np
from repro_torch.core import stream as S
""" + _BATCH_SRC + r"""
real = S._run_chunk
calls = {"n": 0}

def dying(*a, **kw):
    calls["n"] += 1
    if calls["n"] == 3:
        os._exit(9)       # hard kill mid-sweep: no cleanup, no atexit
    return real(*a, **kw)

S._run_chunk = dying
red = S.CellReduce(group=6, cell_ids=np.asarray([0, 1, 0, 1]), n_cells=2)
S.sweep_stream(res_batch(open_every=2), n_steps=80, chunk=6, reduce=red,
               checkpoint_dir=os.environ["CKPT_DIR"], device="cpu")
print("UNREACHABLE")
"""


def test_kill_mid_sweep_then_resume_bit_identical(tmp_path, monkeypatch):
    """A subprocess sweep is hard-killed inside its third chunk; resuming
    from the checkpoint skips the two committed chunks, and the result —
    win counts and open columns included — equals an uninterrupted run."""
    ckpt = str(tmp_path / "ck")
    env = dict(os.environ, CKPT_DIR=ckpt)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, ["src", env.get("PYTHONPATH")]))
    proc = subprocess.run([sys.executable, "-c", _CRASH_SCRIPT],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 9, proc.stdout + proc.stderr
    assert os.path.exists(os.path.join(ckpt, "LATEST"))

    cfgs = res_batch(open_every=2)
    red = S.CellReduce(group=6, cell_ids=np.asarray([0, 1, 0, 1]), n_cells=2)
    clean = S.sweep_stream(cfgs, n_steps=80, chunk=6, reduce=red,
                           device="cpu")
    resumed = S.sweep_stream(cfgs, n_steps=80, chunk=6, reduce=red,
                             checkpoint_dir=ckpt, resume=True, device="cpu")
    assert resumed.resumed_chunks == 2 and resumed.n_chunks == 4
    _assert_summaries_equal(resumed, clean,
                            S.SUMMARY_FIELDS + OPEN_FIELDS, "resume")
    np.testing.assert_array_equal(resumed.wins, clean.wins)

    def boom(*a, **kw):
        raise AssertionError("resume recomputed a committed chunk")

    monkeypatch.setattr(S, "_run_chunk", boom)       # now all committed
    again = S.sweep_stream(cfgs, n_steps=80, chunk=6, reduce=red,
                           checkpoint_dir=ckpt, resume=True, device="cpu")
    assert again.resumed_chunks == again.n_chunks == 4
    _assert_summaries_equal(again, clean, msg="full resume")


def test_resume_refuses_foreign_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ck")
    S.sweep_stream(res_batch(16, seed=3), n_steps=30, chunk=8,
                   checkpoint_dir=ckpt, device="cpu")
    for other in (dict(cfgs=res_batch(16, seed=4), chunk=8),
                  dict(cfgs=res_batch(16, seed=3), chunk=4)):
        with pytest.raises(ValueError, match="refusing to resume"):
            S.sweep_stream(other["cfgs"], n_steps=30, chunk=other["chunk"],
                           checkpoint_dir=ckpt, resume=True, device="cpu")


# --------------------------------------------------------------------------
# the catalog's column builders against the JAX catalog's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("family,kwargs", [
    ("lock_arrival_columns", dict(n_scenarios=3)),
    ("lock_arrival_columns", dict(n_scenarios=2, seed=5, rhos=(0.5, 1.1),
                                  disciplines=("mutable", "ttas"))),
    ("lock_discipline_columns", dict(n_scenarios=4)),
    ("sample_scenario_columns", dict(n_scenarios=6, seed=2)),
    ("lock_scenario_columns", dict(n_scenarios=5, seed=1)),
    ("lock_scenario_columns", dict(n_scenarios=2, locks=("fifo", "ttas"))),
    ("lock_oracle_columns", dict(n_scenarios=3)),
    ("lock_oracle_columns", dict(n_scenarios=2, seed=7, ks=(3,),
                                 sws_maxes=(8, None))),
    ("lock_workload_columns", dict(n_scenarios=3, seed=2)),
    ("lock_workload_columns", dict(n_scenarios=2, workloads=("bursty",),
                                   oracles=("history", "paper"))),
    ("lock_fault_columns", dict(n_scenarios=3, seed=3)),
    ("lock_fault_columns", dict(n_scenarios=2, faults=("preempt",
                                                      "jitter"))),
    ("lock_park_columns", dict(n_scenarios=3, seed=6)),
    ("lock_park_columns", dict(n_scenarios=2, park_costs=(1.0,),
                               disciplines=("sleep", "mutable"))),
])
def test_catalog_columns_equal_reference(family, kwargs):
    got = getattr(tcatalog, family)(**kwargs)
    want = getattr(jcatalog, family)(**kwargs)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["scenario", "oracle", "workload", "fault",
                                  "park"])
def test_sweep_list_and_columns_encode_alike(name):
    """Each new column twin encodes to the arrays of its list builder."""
    cols = getattr(tcatalog, f"lock_{name}_columns")(n_scenarios=2, seed=3)
    cfgs = getattr(tcatalog, f"lock_{name}_sweep")(n_scenarios=2, seed=3)
    a, b = TP.encode_configs(cfgs), TP.encode_configs(cols)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


def test_arrival_sweep_list_and_columns_agree():
    """The port's list builder and column builder encode to the same
    arrays, and its list equals the JAX catalog's field for field."""
    cfgs = tcatalog.lock_arrival_sweep(n_scenarios=2)
    cols = tcatalog.lock_arrival_columns(n_scenarios=2)
    a, b = TP.encode_configs(cfgs), TP.encode_configs(cols)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    jcfgs = jcatalog.lock_arrival_sweep(n_scenarios=2)
    assert [c.__dict__ for c in cfgs] == [c.__dict__ for c in jcfgs]
    assert tcatalog.lock_arrival_capacity(dict(
        cs_hi=1e-5, ncs_hi=3e-5, threads=4, cores=2)) == \
        jcatalog.lock_arrival_capacity(dict(cs_hi=1e-5, ncs_hi=3e-5,
                                            threads=4, cores=2))
    assert tcatalog.lock_arrival_variants() == \
        jcatalog.lock_arrival_variants()
