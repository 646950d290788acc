"""The plain reference equals the program's plain PyTorch version of the
simulator field for field, closed and open loop, and its control (the
reference in bfloat16) does not."""

import numpy as np
import pytest

from portbench import check, control
from portbench import traffic as TR
from portbench.reference import locksim as L

torch = pytest.importorskip("torch")
xdes = pytest.importorskip("repro_torch.core.xdes")
policy = pytest.importorskip("repro_torch.core.policy")
device_mod = pytest.importorskip("repro_torch.device")


def _program(cols, n_steps, open_loop):
    arrs = policy.encode_columns(cols)
    arrs["dt"], _ = xdes.plan_schedule_columns(cols, 150)
    return xdes._simulate_sharded(
        arrs, [device_mod.Shard(torch.device("cpu"))], n_steps, 32,
        backend="ref", rollout="blocked", block_steps=32, target_cs=0,
        early_exit=False, keep_per_thread=False, open_loop=open_loop)


@pytest.mark.parametrize("config,scenarios,seed,n_steps", [
    ("discipline_oracle", 2, 3, 400), ("arrival_slo", 1, 5, 300)])
def test_reference_equals_program(config, scenarios, seed, n_steps):
    cfg = TR.load_json("configs", config)
    cols = TR.build(cfg, {"design": "sampled", "scenarios": scenarios,
                          "design_seed": seed}).cols
    open_loop = "open_loop" in cfg
    out = _program(cols, n_steps, open_loop)
    dt, _ = TR.plan(cols, 150)
    fields = check.SUMMARY + (check.OPEN_SUMMARY + ("lat_hist",)
                              if open_loop else ())
    for i in range(len(cols["lock"])):
        ref = L.simulate_row(TR.encode_row(cols, i, dt[i]), n_steps)
        prog = {f: out[f][i] for f in fields}
        assert check.row_agrees(prog, ref), (i, prog, ref)


def test_control_fails():
    """The control at a size a test run holds: every sampled config's
    bfloat16 summary differs from the float32 one."""
    cfg = dict(TR.load_json("configs", "discipline_oracle"), target_cs=5)
    tr = {"design": "paper", "regimes": {"ss": [3.7e-6, 3.7e-6]},
          "threads": [2, 4], "cores": 20, "wake": 8e-6, "replicates": 1}
    got = control.readings(cfg, tr, [11, 12, 13], workers=1)[:-1]
    assert all(r["rows_differing"] >= r["rows_checked"] // 2 for r in got)
    same = control.readings(cfg, tr, [11], workers=1, precision="float32")
    assert same[0]["rows_differing"] == 0


def test_uniform_matches_program():
    ref_mod = pytest.importorskip("repro_torch.kernels.ref")
    seeds = np.array([0, 1, 2 ** 31 + 5, 2 ** 32 - 1], np.uint64)
    for s in seeds:
        want = ref_mod.counter_uniform(int(s), torch.arange(8),
                                       torch.tensor(77)).numpy()
        got = [L.uniform(int(s), t, 77) for t in range(8)]
        np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    steps = np.arange(100, dtype=np.int64)
    want = ref_mod.counter_uniform(123, 0, torch.from_numpy(steps)).numpy()
    np.testing.assert_array_equal(L.uniform_steps(123, 0, steps), want)
