"""The harness's arithmetic (the window's rate with a stall in it, the
idle share of a synthetic trace, the roofline's count by hand), the
histogram and win-count rules of the check, and a whole run on the CPU
that comes out correct, and not correct for each fault a cell can have."""

import json

import numpy as np
import pytest

from portbench import check, harness, roofline
from portbench import trace as TRC
from portbench import traffic as TR


def test_window_rate_with_a_stall():
    """Sweeps of 1, 1, 5 (a stall) and 1 s against a 6 s window: the
    third ends past the deadline and is the last; 3 sweeps over 7 s."""
    durations = iter([1.0, 1.0, 5.0, 1.0])
    now = [100.0]
    clock = lambda: now[0]

    def sweep(k):
        now[0] += next(durations)
        return None, None

    t0, ends, _, failed = harness.measure(sweep, 6.0, clock)
    assert (t0, ends, failed) == (100.0, [101.0, 102.0, 107.0], 0)
    rate = harness.reader("configs_per_s")(
        {"sweeps": len(ends), "configs_per_sweep": 1000,
         "window_s": ends[-1] - t0})
    assert rate == pytest.approx(3000 / 7.0)


def test_window_runs_at_least_one_sweep():
    now = [0.0]

    def sweep(k):
        now[0] += 2.0
        return k, None

    _, ends, last, _ = harness.measure(sweep, 0.0, lambda: now[0])
    assert ends == [2.0] and last == (0, None)


def test_idle_share_from_a_synthetic_trace():
    """A 10 us window on two cards: card 0 busy 1-3 and 5-6 (two
    overlapping kernels and a copy), card 1 busy 2-7: idle 70 % and 50 %,
    60 % on average; the largest gap on card 0 is under a sync."""
    ev = [(TRC.WINDOW, "user_annotation", 0.0, 10.0, 0),
          ("k", "kernel", 1.0, 2.0, 0), ("k", "kernel", 1.5, 1.0, 0),
          ("Memcpy DtoH", "gpu_memcpy", 5.0, 1.0, 0),
          ("k", "kernel", 2.0, 5.0, 1),
          ("cudaStreamSynchronize", "cuda_runtime", 6.0, 3.9, 7),
          ("aten::empty_like", "cpu_op", 3.0, 2.0, 7)]
    tr = TRC.read(ev)
    assert tr["busy_s"] == {0: pytest.approx(3e-6), 1: pytest.approx(5e-6)}
    assert tr["kernel_s"] == pytest.approx(8e-6)
    ctx = {"trace": tr, "chips": 2, "launches": 4}
    assert harness.reader("device_idle_share")(ctx) == pytest.approx(60.0)
    assert harness.reader("gap_us_per_launch")(ctx) == pytest.approx(3.0)
    assert tr["idle_gaps"][0] == ["cudaStreamSynchronize",
                                  pytest.approx(4e-6)]
    assert dict(tr["idle_gaps"])["aten::empty_like"] == pytest.approx(2e-6)


def test_roofline_count_by_hand():
    """Two closed configs: 8 threads planned 100 steps (4 blocks, 128
    row-steps) and 2 threads planned 64 steps; 46 operations a thread a
    step; 152 bytes a config."""
    cols = {"cs_lo": np.zeros(2), "cs_hi": np.zeros(2),
            "ncs_lo": np.zeros(2), "ncs_hi": np.zeros(2),
            "wake_latency": np.zeros(2), "threads": np.array([8, 2]),
            "cores": np.array([4, 4]), "workload": np.zeros(2, int)}
    plans = (np.full(2, 1e-9, np.float32), np.array([100, 64]))
    orig = TR.plan
    TR.plan = lambda c, t: plans
    try:
        w = roofline.needed_work(cols, 150)
    finally:
        TR.plan = orig
    ops = (128 * 8 + 64 * 2) * 46
    assert w["ops"] == ops
    assert w["bytes"] == 2 * (31 + 7) * 4
    assert w["seconds"] == pytest.approx(ops / (128 * 132 * 1.98e9))
    share = harness.reader("lock_sim_roofline")(
        {"trace": {"kernel_s": 2 * w["seconds"]}, "work": w, "sweeps": 1})
    assert share == pytest.approx(50.0)


def test_hist_agrees():
    ref = np.zeros(64, int)
    ref[[3, 10]] = [2, 1]
    amb = np.zeros(65, int)
    amb[11] = 1                  # the bin-10 departure may sit in bin 11
    moved = ref.copy()
    moved[10], moved[11] = 0, 1
    assert check.hist_agrees(ref, ref, amb)
    assert check.hist_agrees(moved, ref, amb)
    wrong = ref.copy()
    wrong[3], wrong[4] = 1, 1
    assert not check.hist_agrees(wrong, ref, amb)
    assert not check.hist_agrees(moved, ref, np.zeros(65, int))


def test_host_wins_first_maximum():
    completed = np.array([3, 5, 5, 1, 0, 2])
    t_end = np.ones(6, np.float32)
    wins = check.host_wins(completed, t_end, [1, 1], 2, 3)
    np.testing.assert_array_equal(wins, [[0, 0, 0], [0, 1, 1]])


# -- whole runs on the CPU ---------------------------------------------------
torch = pytest.importorskip("torch")
xdes = pytest.importorskip("repro_torch.core.xdes")
K = pytest.importorskip("repro_torch.kernels.lock_sim")

SPEC = {"end_to_end": [{"name": "configs_per_s", "unit": "configs/s"},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": []}
CELL = ({"name": "tiny", "config": "discipline_oracle", "traffic": "tiny",
         "chips": 1},
        dict(TR.load_json("configs", "discipline_oracle"), target_cs=5),
        {"design": "paper", "regimes": {"ss": [3.7e-6, 3.7e-6]},
         "threads": [2, 4], "cores": 20, "wake": 8e-6, "replicates": 1})


def _run(seed=4_000_000_123):
    out = harness.run("tiny", seed, 0.0, False, 0.0, device="cpu",
                      spec=SPEC, cell=CELL, require_chips=False, workers=1)
    json.dumps(out)
    return out


@pytest.mark.parametrize("shards", ["1", "2"])
def test_sound_run_is_correct(shards, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_SHARDS", shards)
    out = _run()
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"configs_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


def _state_unchanged():
    real, calls = K.lock_sim_block, [0]

    def block(*a, **k):
        calls[0] += 1
        out = real(*a, **k)
        if calls[0] % 3 == 0:  # a block returns its state as it got it
            return tuple(a[:17]) + tuple(k.get("open_state") or ())
        return out
    return K, "lock_sim_block", block


def _answer_altered():
    real = K.lock_sim_block

    def block(*a, **k):
        out = list(real(*a, **k))
        out[14] = out[14] + 1       # completed, where the kernel makes it
        return tuple(out)
    return K, "lock_sim_block", block


def _half_left_out():
    real = xdes.simulate_columns

    def simulate(arrs, *a, **k):
        n = arrs["policy"].shape[0]
        half = {key: v[:n // 2] for key, v in arrs.items()}
        out = real(half, *a, **k)
        return {key: np.concatenate([v, np.repeat(
            v.mean(axis=0, keepdims=True).astype(v.dtype), n - n // 2,
            axis=0)]) for key, v in out.items()}
    return xdes, "simulate_columns", simulate


def _exchange_left_out():
    real = xdes._simulate_core

    def core(parts, *a, **k):
        out = real(parts[:1], *a, **k)           # one shard's rows only
        return {key: np.concatenate([v] * len(parts))
                for key, v in out.items()}
    return xdes, "_simulate_core", core


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _exchange_left_out, _answer_altered])
def test_each_fault_is_not_correct(fault, monkeypatch):
    # the exchange exists only in a split: two shards there
    shards = "2" if fault is _exchange_left_out else "1"
    monkeypatch.setenv("REPRO_TORCH_SHARDS", shards)
    mod, name, broken = fault()
    monkeypatch.setattr(mod, name, broken)
    out = _run()
    assert not out["correct"], out["checks"]


def test_names_and_units():
    """Every name and unit of BENCHMARK.json keeps to its characters."""
    import re

    spec = harness.load_spec()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    metrics = spec["end_to_end"] + spec["per_layer"]
    names = [x["name"] for x in spec["configs"] + spec["workloads"]
             + metrics]
    names += [w[k] for w in spec["workloads"] for k in ("config",
                                                        "traffic")]
    names += [k for c in spec["configs"] for k in c["reduced"]]
    assert all(name.match(n) for n in names), names
    assert all(unit.match(m["unit"]) for m in metrics)
    for m in metrics:
        assert (harness.ROOT / "portbench" / "metrics"
                / f"{m['name']}.py").exists()
    for w in spec["workloads"]:
        assert (harness.ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").exists()
        assert len(w["why"]) <= 200
