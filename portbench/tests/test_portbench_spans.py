"""The readers of the program's spans and counters (``stream_host_ms``,
``flag_wait_us``, ``launch_host_us``, ``done_row_steps``): a whole traced
run on the CPU reads a finite number for each, an untraced run reports
none of them, and a ``ctx`` with no session (or a program without
``repro_torch.trace``) reads ``None``."""

import math
import sys

import pytest

from portbench import harness

torch = pytest.importorskip("torch")
trace = pytest.importorskip("repro_torch.trace")

from test_portbench_harness import CELL  # noqa: E402

NEW = ("stream_host_ms", "flag_wait_us", "launch_host_us", "done_row_steps")
SPEC = {"end_to_end": [{"name": "configs_per_s", "unit": "configs/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": n, "unit": "-", "moves": "configs_per_s"}
                      for n in NEW]}


def _run(traced):
    return harness.run("tiny", 4_000_000_321, 0.0, traced, 0.0,
                       device="cpu", spec=SPEC, cell=CELL,
                       require_chips=False, workers=1)


@pytest.mark.parametrize("shards", ["1", "2"])
def test_traced_run_reads_each_metric(shards, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SHARDS", shards)
    out = _run(True)
    assert out["correct"], out["checks"]
    for n in NEW:
        v = out["metrics"][n]["value"]
        assert math.isfinite(v) and v >= 0, (n, v)
    assert 0 < out["metrics"]["done_row_steps"]["value"] < 100
    # the window's session: one stream.sweep a sweep of the window
    st = trace.session().stats()
    assert st["stream.sweep"]["count"] == out["attempted"]


def test_untraced_run_reports_none_of_them():
    out = _run(False)
    assert set(out["metrics"]) == {"configs_per_s", "setup_s"}


def test_readers_by_hand_and_none_without_a_session(monkeypatch):
    """A session of one 4 ms sweep around a 1 ms rollout, a 2 us flag and
    a 1 us launch, 10 of 40 row-steps done, reads 3 ms, 2 us, 1 us and
    25 %; no session, or a program without ``repro_torch.trace``, reads
    None."""
    import repro_torch

    monkeypatch.setattr(trace, "_session", None)
    assert [harness.reader(n)({}) for n in NEW] == [None] * 4
    s = trace.Session()
    s.records += [("stream.sweep", 0, -1, 0, None, 0, 4_000_000),
                  ("rollout.core", 1, 0, 0, None, 1_000_000, 2_000_000),
                  ("rollout.block", 2, 1, 0, 0, 1_000_000, 1_001_000),
                  ("wrappers.launch", 3, 2, 0, 0, 1_000_000, 1_001_000),
                  ("rollout.flag", 4, 1, 0, 0, 1_001_000, 1_003_000)]
    s.counters.update({"rollout.row_steps": 40,
                       "rollout.done_row_steps": 10})
    monkeypatch.setattr(trace, "_session", s)
    assert [harness.reader(n)({}) for n in NEW] == \
        [pytest.approx(v) for v in (3.0, 2.0, 1.0, 25.0)]
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert [harness.reader(n)({}) for n in NEW] == [None] * 4
