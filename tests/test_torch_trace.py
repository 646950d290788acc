"""The sweep path's spans and counters, ``repro_torch.trace``, on
``device="cpu"``: nothing recorded without a profiler and the same results
with one; the spans' tree, shards and sweep ids; their times against the
profiler's own events of the same name; the flag read's operations; the
done row-steps against a block-by-block replay of the plain reference; a
new session for a new profiler."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro_torch import trace
from repro_torch.core import policy as P
from repro_torch.core import stream as S
from repro_torch.core import xdes
from repro_torch.core.policy import SimConfig
from repro_torch.kernels import ref

TARGET = 5
LOCKS = ("ttas", "fifo", "sleep", "mutable", "adaptive", "mcs")

#: Each span's parent in the tree (None: a root).
PARENT = {"stream.sweep": None, "stream.encode": "stream.sweep",
          "stream.plan": "stream.sweep", "stream.copy_in": "stream.sweep",
          "rollout.core": "stream.sweep", "rollout.block": "rollout.core",
          "wrappers.launch": "rollout.block",
          "rollout.flag": "rollout.core", "stream.copy_back": "stream.sweep",
          "stream.reduce": "stream.sweep"}
#: Spans that come once for each shard (and each chunk or block).
PER_SHARD = ("rollout.block", "rollout.flag", "stream.copy_in",
             "stream.copy_back")


def _configs(n=6, seed=5):
    rng = np.random.default_rng(seed)
    return [SimConfig(LOCKS[i % 6], threads=int(rng.integers(2, 6)),
                      cores=int(rng.integers(2, 5)), cs=(0.0, 3.7e-6),
                      ncs=(0.0, float(rng.uniform(2e-6, 2e-5))),
                      wake_latency=8e-6, seed=int(rng.integers(0, 1000)),
                      oracle=("paper", "aimd", "fixed")[i % 3])
            for i in range(n)]


def _reduce(n, group=6):
    return S.CellReduce(group, np.zeros(n // group, np.int32), 1)


def _sweep(configs=None):
    configs = configs or _configs()
    return S.sweep_stream(configs, target_cs=TARGET, device="cpu",
                          reduce=_reduce(len(configs)))


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture
def fresh(monkeypatch):
    """No session and no profiler seen yet, whatever ran before in the
    process."""
    monkeypatch.setattr(trace, "_session", None)
    monkeypatch.setattr(trace, "_was_on", False)
    monkeypatch.setattr(trace, "_fresh", False)


def _records(s, name=None):
    return [dict(zip(trace.FIELDS, r)) for r in s.records
            if name is None or r[0] == name]


def test_off_records_nothing_and_results_equal_traced(fresh, monkeypatch):
    """Without a profiler no span object is built and no session starts;
    under one the StreamResult is the same bit for bit."""
    def no_span(*a, **k):
        raise AssertionError("a span was built with tracing off")

    with monkeypatch.context() as m:
        m.setattr(trace, "_Span", no_span)
        off = _sweep()
    assert trace.session() is None
    on, _ = _profiled(_sweep)
    assert trace.session() is not None
    for f in S.SUMMARY_FIELDS + ("dt", "wins"):
        np.testing.assert_array_equal(getattr(off, f), getattr(on, f), f)
    assert (off.n_steps, off.n_chunks) == (on.n_steps, on.n_chunks)


@pytest.mark.parametrize("shards", ["1", "2"])
def test_spans_nest_and_carry_their_shard(shards, fresh, monkeypatch):
    """Two sweeps under one profiler: the tree of PARENT by ids, one sweep
    id a sweep_stream call, every per-shard span once for each shard with
    its index, and self time = duration less the children's."""
    monkeypatch.setenv("REPRO_TORCH_SHARDS", shards)
    n = int(shards)
    (a, b), _ = _profiled(lambda: (_sweep(), _sweep(_configs(seed=6))))
    s = trace.session()
    recs = _records(s)
    by_id = {r["id"]: r for r in recs}
    assert {r["name"] for r in recs} == set(PARENT)
    for r in recs:
        want = PARENT[r["name"]]
        got = by_id[r["parent"]]["name"] if r["parent"] >= 0 else None
        assert got == want, r
        assert r["start_ns"] <= r["end_ns"]
        if r["parent"] >= 0:
            p = by_id[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] \
                <= p["end_ns"]
    roots = _records(s, "stream.sweep")
    assert len(roots) == 2
    assert {r["sweep"] for r in recs} == {r["id"] for r in roots}
    for root in roots:
        mine = [r for r in recs if r["sweep"] == root["id"]]
        flags = [r for r in mine if r["name"] == "rollout.flag"]
        blocks = [r for r in mine if r["name"] == "rollout.block"]
        assert len(blocks) == len(flags) > 0
        for name in PER_SHARD:
            got = [r["shard"] for r in mine if r["name"] == name]
            assert sorted(got) == sorted(list(range(n)) * (len(got) // n))
            assert len(got) % n == 0
        for r in mine:
            if r["name"] == "wrappers.launch":
                assert r["shard"] == by_id[r["parent"]]["shard"]
    # one flag a shard and block: blocks run = steps_run / 32 a chunk
    assert len(_records(s, "rollout.block")) == n * sum(
        -(-int(x.steps_run.max()) // xdes.DEFAULT_BLOCK_STEPS)
        for x in (a, b))
    st = s.stats()
    child = sum(r["end_ns"] - r["start_ns"] for r in recs
                if r["parent"] >= 0 and by_id[r["parent"]]["name"]
                == "stream.sweep")
    assert st["stream.sweep"]["count"] == 2
    assert st["stream.sweep"]["self_ns"] == \
        st["stream.sweep"]["total_ns"] - child
    assert all(0 <= v["self_ns"] <= v["total_ns"] for v in st.values())


def test_spans_agree_with_the_profilers_events(fresh):
    """Each span is the profiler's host event of the same name, start and
    end within 1 ms (the Kineto events' clock is Unix-epoch ns), an
    operation and not a user annotation (which Kineto would project onto
    the card's timeline as device time)."""
    _, prof = _profiled(_sweep)
    s = trace.session()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() in PARENT]
    assert len(events) == len(s.records)
    assert {e.activity_type() for e in events} == {"cpu_op"}
    for name in PARENT:
        ours = sorted(_records(s, name), key=lambda r: r["start_ns"])
        theirs = sorted((e for e in events if e.name() == name),
                        key=lambda e: e.start_ns())
        assert len(ours) == len(theirs) > 0, name
        for r, e in zip(ours, theirs):
            assert abs(r["start_ns"] - e.start_ns()) < 1_000_000, name
            assert abs(r["end_ns"] - e.end_ns()) < 1_000_000, name


def test_flag_read_is_one_reduction_and_one_item(fresh):
    """Inside every rollout.flag span the host runs one compare, one sum
    (no cast before it) and one item, no other op at the top: the count
    costs what the flag did."""
    _, prof = _profiled(_sweep)
    ev = [(e.name(), e.start_ns(), e.end_ns())
          for e in prof.profiler.kineto_results.events()]
    flags = [(a, b) for n, a, b in ev if n == "rollout.flag"]
    assert flags
    for a, b in flags:
        inside = sorted((s, -t, n) for n, s, t in ev
                        if a <= s and t <= b and n != "rollout.flag")
        top, reach = [], a
        for s, t, n in inside:      # the ops not nested in another
            if s >= reach:
                top.append(n)
                reach = -t
        assert top == ["aten::ge", "aten::sum", "aten::item"], top


def _replay(configs, target_cs, B=xdes.DEFAULT_BLOCK_STEPS):
    """Row-steps and done row-steps of the blocked rollout with early exit,
    replayed block by block on the plain reference: before each block,
    the rows whose completed already reached target_cs."""
    dt, steps = xdes.plan_schedule(configs, target_cs)
    n_steps = min(int(steps.max()), xdes.MAX_STEPS)
    arrs = P.encode_configs(configs)
    arrs["dt"] = np.asarray(dt, np.float32)
    cols = xdes.columns_from_numpy(arrs, "cpu")
    T = int(arrs["threads"].max())
    state = xdes._init_state(cols, T)
    prm = tuple(cols[f] for f in xdes._PRM_FIELDS)
    has_budget = P.discipline_flags(cols["policy"])[2] > 0
    rows, done, step0 = len(configs), 0, 0
    row_steps = 0
    while step0 < n_steps:
        k = min(B, n_steps - step0)
        at = int((state[14] >= target_cs).sum())
        row_steps += rows * k
        done += at * k
        state = ref.lock_sim_block_ref(
            *state[:17], step0, cols["alpha"], cols["cores"], has_budget,
            *prm, n_sub_steps=B, limit=n_steps)
        step0 += B
        if bool((state[14] >= target_cs).all()):
            break
    return row_steps, done


@pytest.mark.parametrize("shards", ["1", "2"])
def test_done_row_steps_equal_a_replay_of_the_reference(shards, fresh,
                                                        monkeypatch):
    """rollout.row_steps and rollout.done_row_steps of a traced
    simulate_batch (summed over the shards) equal the replay's."""
    monkeypatch.setenv("REPRO_TORCH_SHARDS", shards)
    configs = _configs(seed=9)
    _profiled(lambda: xdes.simulate_batch(configs, target_cs=TARGET,
                                          device="cpu"))
    c = trace.session().counters
    row_steps, done = _replay(configs, TARGET)
    assert 0 < done < row_steps
    assert (c["rollout.row_steps"], c["rollout.done_row_steps"]) == \
        (row_steps, done)


def test_a_second_profiler_starts_a_new_session(fresh):
    """A profiled sweep, an untraced one (which leaves the session as it
    is), a profiled one: the second profiler's session holds its sweep
    alone."""
    _profiled(_sweep)
    first = trace.session()
    _sweep()
    assert trace.session() is first
    _profiled(_sweep)
    second = trace.session()
    assert second is not first
    assert [s.stats()["stream.sweep"]["count"] for s in (first, second)] \
        == [1, 1]
    assert trace.session().counters["rollout.row_steps"] > 0
