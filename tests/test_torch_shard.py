"""The simulator's config-axis split on the port, on ``device="cpu"``.

``REPRO_TORCH_SHARDS`` (``repro_torch.device.ENV_SHARDS``), set here with
``monkeypatch``, forces N shards, N copies of the CPU device: the CPU
counterpart of XLA's ``--xla_force_host_platform_device_count``.

* ``simulate_batch(shard=True)`` at 1, 2, 3, 4 and 8 shards equals
  ``shard=False`` bit for bit in every ``BatchResult`` field, on the
  reference's own sharded cases (``tests/test_blocked_rollout.py``: six
  configs padded, a pinned horizon of 300; early exit; bucketed with more
  than one bucket), more shards than configs, ``rollout="scan"``, an
  open-loop batch and ``keep_per_thread=False``.
* ``sweep_stream(shard=True)`` at 4 shards equals the unsharded one-shot
  run (``tests/test_stream.py``'s case, three chunks of 8), and a
  reduction group that does not divide the shard count plans chunks of
  ``lcm(group, 4)``.
* Each grid at 4 shards equals the same grid at 1, and records the split
  in its meta; a writer gives the same CSV bytes with and without
  ``--no-shard``.
* Against the JAX package: one subprocess with
  ``--xla_force_host_platform_device_count=4`` runs the reference's
  sharded cases and ``sweep_stream(shard=True)``; the port's 4-shard runs
  match them under ROADMAP C12's contract, every integer equal and every
  float within rtol 2e-2.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro_torch.bench import discipline_diagram as tdisc
from repro_torch.bench import sweep as tsweep
from repro_torch.core import stream as S
from repro_torch.core import xdes as txdes
from repro_torch.core.policy import SimConfig
from repro_torch.device import ENV_SHARDS, shard_count, shard_devices
from test_torch_bench_grids import SHARDED, assert_results_agree

SHORT = (0.0, 3.7e-6)
LOCKS = ("ttas", "fifo", "sleep", "mutable", "adaptive", "mcs")
INT_FIELDS = ("completed", "final_sws", "wake_count", "completed_per_thread",
              "steps_run", "fairness", "lat_hist", "arrived", "shed",
              "departed", "slo_viol", "in_flight")
FLOAT_FIELDS = ("spin_cpu", "t_end", "dt", "lat_sum", "occ_int")
#: The reference's float band (ROADMAP C12).
RTOL = 2e-2


def _six(threads=5, cores=4):
    return [SimConfig(lk, threads=threads, cores=cores, cs=SHORT, ncs=SHORT,
                      wake_latency=8e-6, seed=i) for i, lk in enumerate(LOCKS)]


#: The bucketed case's CS and NCS bounds, one config each.
HET_HI = (3e-6, 1e-5, 5e-6, 1.2e-5, 4e-6, 8e-6)
#: Horizons and targets of the cases (see CASES), shared with the
#: reference's script.
PINNED_STEPS, EARLY_CS, BUCKET_CS, STREAM_STEPS = 40, 6, 2, 24


def _het():
    return [SimConfig("mutable", threads=5, cores=4, cs=(0.0, hi),
                      ncs=(0.0, hi), wake_latency=8e-6, seed=i)
            for i, hi in enumerate(HET_HI)]


def _open():
    rng = np.random.default_rng(3)
    return [SimConfig(LOCKS[i % 6], threads=int(rng.integers(2, 7)),
                      cores=4, cs=SHORT, ncs=(0.0, 8e-6), wake_latency=8e-6,
                      seed=i, arrival=("poisson", "closed", "bursty")[i % 3],
                      arrival_rate=float(rng.uniform(1e5, 1e6)),
                      queue_cap=int(rng.integers(2, 32)))
            for i in range(7)]


#: name -> (configs, simulate_batch keywords).  The first three are the
#: reference's sharded cases (tests/test_blocked_rollout.py) at shorter
#: horizons: the plain versions cost about 13 ms a timestep a shard on
#: the CPU whatever the rows, and the reference's bucketed case plans
#: 6215 steps.  Kept: six configs padded to a multiple of 4 and 8, a tail
#: block (40 = 32 + 8), early exit firing (96 of 100 steps), two buckets
#: (4 + 2 configs, horizons 33 and 37).
CASES = {
    "pinned_padded": (_six, dict(n_steps=PINNED_STEPS)),
    "early_exit": (lambda: _six(threads=4, cores=8),
                   dict(target_cs=EARLY_CS)),
    "bucketed": (_het, dict(target_cs=BUCKET_CS, bucket_steps=True)),
    "scan": (_six, dict(n_steps=24, rollout="scan")),
    "open_loop": (_open, dict(n_steps=64)),
    "no_per_thread": (_six, dict(n_steps=40, keep_per_thread=False)),
}
#: (case, shards): every shard count on the pinned case (8 shards: more
#: shards than configs), four shards (6 % 4 != 0) on every other, three
#: on the bucketed one.
SPLITS = ([("pinned_padded", n) for n in (1, 2, 3, 4, 8)]
          + [(c, 4) for c in CASES if c != "pinned_padded"]
          + [("bucketed", 3)])

_RUNS: dict = {}


def run(case: str, n: int = 0):
    """A case unsharded (``n=0``) or at ``n`` forced shards, once per
    module."""
    if (case, n) not in _RUNS:
        cfgs, kw = CASES[case]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(ENV_SHARDS, str(max(n, 1)))
            _RUNS[case, n] = txdes.simulate_batch(cfgs(), shard=n > 0,
                                                  device="cpu", **kw)
    return _RUNS[case, n]


def assert_batches_equal(got, want, msg=""):
    """Every field of two results bit for bit, ``None`` against ``None``."""
    for f in INT_FIELDS + FLOAT_FIELDS:
        a, b = getattr(got, f, None), getattr(want, f, None)
        assert (a is None) == (b is None), f"{msg}: {f}"
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}: {f}")
    assert got.n_steps == want.n_steps, msg


# --------------------------------------------------------------------------
# against the JAX package's sharded path
# --------------------------------------------------------------------------
_REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import numpy as np
import jax
from repro.core import stream as xstream
from repro.core import xdes
from repro.core.policy import SimConfig

assert len(jax.devices()) == 4
HET_HI, PINNED_STEPS, EARLY_CS, BUCKET_CS, STREAM_STEPS = PARAMS
SHORT = (0.0, 3.7e-6)
locks = ["ttas", "fifo", "sleep", "mutable", "adaptive", "mcs"]
six = lambda th, co: [SimConfig(l, threads=th, cores=co, cs=SHORT, ncs=SHORT,
                                wake_latency=8e-6, seed=i)
                      for i, l in enumerate(locks)]
het = [SimConfig("mutable", threads=5, cores=4, cs=(0.0, hi),
                 ncs=(0.0, hi), wake_latency=8e-6, seed=i)
       for i, hi in enumerate(HET_HI)]
runs = {
    "pinned_padded": xdes.simulate_batch(six(5, 4), n_steps=PINNED_STEPS,
                                         shard=True),
    "early_exit": xdes.simulate_batch(six(4, 8), target_cs=EARLY_CS,
                                      shard=True),
    "bucketed": xdes.simulate_batch(het, target_cs=BUCKET_CS,
                                    bucket_steps=True, shard=True),
}
cfgs = [SimConfig(l, threads=5, cores=4, cs=SHORT, ncs=SHORT,
                  wake_latency=8e-6, seed=s) for s in range(4) for l in locks]
runs["stream"] = xstream.sweep_stream(cfgs, n_steps=STREAM_STEPS, shard=True,
                                      chunk=8)
out = {}
for name, r in runs.items():
    for f in ("completed", "final_sws", "wake_count", "completed_per_thread",
              "steps_run", "fairness", "spin_cpu", "t_end", "dt"):
        v = getattr(r, f, None)
        if v is not None:
            out[f"{name}.{f}"] = np.asarray(v)
out["stream.n_chunks"] = np.asarray(runs["stream"].n_chunks)
np.savez(sys.argv[1], **out)
print("REF-SHARDED-OK")
"""


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The JAX package's 4-device run, started once for the module and
    read by the test that needs it (it runs while the port's tests do)."""
    path = str(tmp_path_factory.mktemp("ref") / "ref.npz")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, ["src", env.get("PYTHONPATH")]))
    env.pop("XLA_FLAGS", None)
    params = repr((HET_HI, PINNED_STEPS, EARLY_CS, BUCKET_CS, STREAM_STEPS))
    proc = subprocess.Popen([sys.executable, "-c",
                             _REF_SCRIPT.replace("PARAMS", params), path],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


# --------------------------------------------------------------------------
# the port against itself
# --------------------------------------------------------------------------
def test_shard_devices_follow_the_forced_count(reference_run, monkeypatch):
    # the first test asks for the reference's run, so that its subprocess
    # works while the port's runs below do
    monkeypatch.delenv(ENV_SHARDS, raising=False)
    assert shard_count("cpu") == 1
    assert [s.device.type for s in shard_devices("cpu")] == ["cpu"]
    if not torch.cuda.is_available():
        assert shard_count() == 0              # no card: nothing visible
        with pytest.raises(RuntimeError, match="CUDA"):
            shard_devices()                    # device=None is the card
    monkeypatch.setenv(ENV_SHARDS, "3")
    shards = shard_devices("cpu")
    assert len(shards) == shard_count("cpu") == 3
    assert all(s.device == torch.device("cpu") and s.stream is None
               for s in shards)
    monkeypatch.setenv(ENV_SHARDS, "0")
    with pytest.raises(ValueError, match=ENV_SHARDS):
        shard_count("cpu")


@pytest.mark.parametrize("case,n", SPLITS)
def test_sharded_equals_unsharded(case, n):
    got = run(case, n)
    assert_batches_equal(got, run(case), f"{case} at {n} shards")
    if case == "early_exit":
        assert (got.steps_run < got.n_steps).all()
    if case == "bucketed":
        assert len(set(got.steps_run.tolist())) > 1


def test_shard_none_splits_iff_more_than_one(monkeypatch):
    calls = []
    real = txdes._simulate_core

    def core(parts, *a, **k):
        calls.append(len(parts))
        return real(parts, *a, **k)

    monkeypatch.setattr(txdes, "_simulate_core", core)
    cfgs, kw = CASES["pinned_padded"]
    for n in (1, 2):
        monkeypatch.setenv(ENV_SHARDS, str(n))
        auto = txdes.simulate_batch(cfgs(), device="cpu", **kw)
        assert_batches_equal(auto, run("pinned_padded"), f"auto at {n}")
    assert calls == [1, 2]


def _stream_cfgs():
    return [SimConfig(lk, threads=5, cores=4, cs=SHORT, ncs=SHORT,
                      wake_latency=8e-6, seed=s)
            for s in range(4) for lk in LOCKS]        # 24 configs


def stream_run():
    """``tests/test_stream.py``'s sharded case at 4 forced shards (at
    :data:`STREAM_STEPS`), once per module."""
    if "stream" not in _RUNS:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv(ENV_SHARDS, "4")
            _RUNS["stream"] = S.sweep_stream(
                _stream_cfgs(), n_steps=STREAM_STEPS, shard=True, chunk=8,
                device="cpu")
    return _RUNS["stream"]


def test_sweep_stream_sharded_equals_one_shot(monkeypatch):
    cfgs = _stream_cfgs()
    one = txdes.simulate_batch(cfgs, n_steps=STREAM_STEPS, shard=False,
                               keep_per_thread=False, device="cpu")
    s = stream_run()
    assert (s.n_chunks, s.chunk_size) == (3, 8)
    for f in S.SUMMARY_FIELDS:
        np.testing.assert_array_equal(getattr(s, f), getattr(one, f),
                                      err_msg=f)
    monkeypatch.setenv(ENV_SHARDS, "4")
    with pytest.raises(ValueError, match="quantum 4"):
        S.sweep_stream(cfgs, n_steps=STREAM_STEPS, shard=True, chunk=6,
                       device="cpu")


def test_sweep_stream_group_not_dividing_the_shards(monkeypatch, tmp_path):
    """Reduction groups of 3 over 4 shards: the quantum is 12, the OOM
    backoff halves a chunk of 24 down to it, wins and summaries equal the
    unsharded sweep's, and a sharded checkpoint never resumes an
    unsharded one."""
    cfgs = _stream_cfgs()
    red = S.CellReduce(group=3, cell_ids=np.arange(8) % 3, n_cells=3)
    kw = dict(n_steps=STREAM_STEPS, reduce=red, device="cpu")
    ckpt = str(tmp_path / "ck")
    want = S.sweep_stream(cfgs, shard=False, chunk=12, checkpoint_dir=ckpt,
                          **kw)
    monkeypatch.setenv(ENV_SHARDS, "4")
    with pytest.raises(ValueError, match="quantum 12"):
        S.sweep_stream(cfgs, shard=True, chunk=6, **kw)
    with pytest.raises(ValueError, match="different sweep plan"):
        S.sweep_stream(cfgs, shard=True, chunk=12, checkpoint_dir=ckpt,
                       resume=True, **kw)

    calls = []
    real = S._run_chunk

    def oom_above_quantum(arrs, *a, **k):
        calls.append(arrs["policy"].shape[0])
        if arrs["policy"].shape[0] > 12:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return real(arrs, *a, **k)

    monkeypatch.setattr(S, "_run_chunk", oom_above_quantum)
    budget = (24.5 * S.bytes_per_config(5)) / 2**20    # 24 configs fit
    with pytest.warns(UserWarning, match="halved"):
        got = S.sweep_stream(cfgs, mem_mb=budget, **kw)    # shard=None
    assert (got.chunk_size, got.n_chunks, calls) == (24, 1, [24, 12, 12])
    for f in S.SUMMARY_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    np.testing.assert_array_equal(got.wins, want.wins)


@pytest.mark.parametrize("grid", list(SHARDED))
def test_grid_at_four_shards_equals_one(grid, monkeypatch):
    runs = {}
    for n in (4, 1):
        monkeypatch.setenv(ENV_SHARDS, str(n))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # step-cap notes, nan-means
            runs[n] = getattr(tsweep, grid)(device="cpu", verbose=False,
                                            **SHARDED[grid])
    assert assert_results_agree(runs[4], runs[1], rtol=0.0) == 0.0
    if grid != "refine_grid":
        assert [(runs[n]["meta"]["n_devices"], runs[n]["meta"]["sharded"])
                for n in (4, 1)] == [(4, True), (1, False)]


def test_writer_csv_equal_with_and_without_no_shard(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV_SHARDS, "4")
    assert tdisc.auto_scenarios(24, 15, device="cpu") == 96
    csv = {}
    for flag in ([], ["--no-shard"]):
        out = tmp_path / (flag[0][2:] if flag else "split") / "d.json"
        res = tdisc.main(["--device", "cpu", "--scenarios", "1",
                          "--target-cs", "2", "--out", str(out), *flag])
        assert res["meta"]["sharded"] is not bool(flag)
        csv[bool(flag)] = (out.parent
                           / "discipline_phase_diagram.csv").read_bytes()
    assert csv[True] == csv[False]


# --------------------------------------------------------------------------
# the port's 4 shards against the reference's 4 devices (last: the
# subprocess started by the first test has had the module's time)
# --------------------------------------------------------------------------
def test_four_shards_match_the_reference_four_devices(reference_run):
    proc, path = reference_run
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "REF-SHARDED-OK" in out, out + err
    ref = dict(np.load(path))
    got = {name: run(name, 4)
           for name in ("pinned_padded", "early_exit", "bucketed")}
    got["stream"] = stream_run()
    assert int(ref["stream.n_chunks"]) == got["stream"].n_chunks == 3
    for key, want in ref.items():
        name, f = key.split(".")
        if f == "n_chunks":
            continue
        have = np.asarray(getattr(got[name], f))
        if f in INT_FIELDS:
            np.testing.assert_array_equal(have, want, err_msg=key)
        else:
            np.testing.assert_allclose(have, want, rtol=RTOL, err_msg=key)
