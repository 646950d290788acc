"""The port's sweep layer, ``repro_torch.bench``, against the JAX
package's ``benchmarks/`` on the CPU: the closed one-shot grids
(``scenario``, ``oracle_grid``, ``discipline_grid``, ``workload_grid``,
``fault_grid``, ``park_grid``) on the same seeds and parameters, and the
five closed-grid diagram writers fed one result dict made by the
reference.

The port runs its plain PyTorch versions (``device="cpu"``); the reference
runs jitted with ``backend="ref"`` and ``shard=False``, as its own tests
run it.  The result dicts are compared key for key, leaving out
``wall_s``, ``configs_per_s``, ``backend`` and the device keys: every
integer and string (wins, ``n``, winners, config, step and chunk counts)
equal, every float (means, ratios, percentiles) within rtol 2e-2, the band
of ``tests/test_torch_xdes.py::test_throughput_band_against_jitted_reference``.
The sizes (1-3 scenarios, target_cs 5) keep the plain versions' CPU time
to a few seconds a grid.
"""

import math
import warnings

import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from benchmarks import discipline_diagram as jdisc
from benchmarks import fault_diagram as jfault
from benchmarks import oracle_ablation as joracle
from benchmarks import park_diagram as jpark
from benchmarks import sweep as jsweep
from benchmarks import workload_diagram as jwork
from repro_torch.bench import discipline_diagram as tdisc
from repro_torch.bench import fault_diagram as tfault
from repro_torch.bench import oracle_ablation as toracle
from repro_torch.bench import park_diagram as tpark
from repro_torch.bench import sweep as tsweep
from repro_torch.bench import workload_diagram as twork

#: Result keys that name the run, not its answer.
RUN_KEYS = frozenset({"wall_s", "configs_per_s", "backend", "device",
                      "n_devices", "sharded"})
#: The float band (see the module docstring).
RTOL = 2e-2


def assert_results_agree(got, want, rtol=RTOL, path="result"):
    """Walk two result dicts in step: the same keys (less ``RUN_KEYS``),
    integers, strings, bools and ``None`` equal, floats within ``rtol``
    (NaN only against NaN).  Returns the largest relative float
    difference seen."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert set(got) - RUN_KEYS == set(want) - RUN_KEYS, \
            (path, set(got) ^ set(want))
        return max([assert_results_agree(got[k], want[k], rtol,
                                         f"{path}.{k}")
                    for k in want if k not in RUN_KEYS] or [0.0])
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            path
        return max([assert_results_agree(g, w, rtol, f"{path}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))] or [0.0])
    if isinstance(want, float) and not isinstance(got, bool):
        assert isinstance(got, float), (path, got, want)
        if math.isnan(want) or math.isnan(got):
            assert math.isnan(want) and math.isnan(got), (path, got, want)
            return 0.0
        rel = abs(got - want) / max(abs(want), abs(got), 1e-300)
        assert rel <= rtol, (path, got, want)
        return rel
    assert type(got) is type(want) and got == want, (path, got, want)
    return 0.0


def run_both(grid: str, **kw):
    """(port result, reference result) of one grid on the same arguments;
    ``shard=False`` where the reference's grid takes it."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # step-cap notes, nan-means
        got = getattr(tsweep, grid)(device="cpu", verbose=False, **kw)
        if grid not in ("scenario", "oracle_grid"):
            kw = dict(kw, shard=False)
        want = getattr(jsweep, grid)(backend="ref", verbose=False, **kw)
    return got, want


_CACHE: dict = {}


def cached(grid: str, **kw):
    """``run_both`` once per grid and arguments in this module: the grid
    and writer tests share one pair."""
    key = (grid, tuple(sorted(kw.items())))
    if key not in _CACHE:
        _CACHE[key] = run_both(grid, **kw)
    return _CACHE[key]


#: The closed one-shot grids as tested: (grid, arguments).  scenario runs
#: two step-count buckets (66 and 85 planned steps).
ONE_SHOT = {
    "scenario": dict(n_scenarios=2, target_cs=5),
    "oracle_grid": dict(n_scenarios=2, target_cs=5),
    "discipline_grid": dict(n_scenarios=2, target_cs=5),
    "workload_grid": dict(n_scenarios=1, target_cs=5),
    "fault_grid": dict(n_scenarios=1, target_cs=5),
    "park_grid": dict(n_scenarios=1, target_cs=5),
}


@pytest.mark.parametrize("grid", list(ONE_SHOT))
def test_one_shot_grid_equals_reference(grid):
    """Measured largest relative float difference (jax 0.9.0 CPU against
    torch 2.13 CPU): 4.96e-08 (scenario, discipline_grid), 0.0
    (oracle_grid), 1.2e-07 (workload_grid), 2.25e-07 (fault_grid),
    9.66e-08 (park_grid); every winner and win count equal."""
    got, want = cached(grid, **ONE_SHOT[grid])
    assert got["meta"]["streamed"] is False
    assert got["meta"]["device"] == "cpu"
    if "n_devices" in want["meta"]:
        assert got["meta"]["n_devices"] == 1
        assert got["meta"]["sharded"] is False
    if grid != "scenario":
        assert sum(c["n"] for c in got["phase"]) == \
            got["meta"]["n_configs"] // got["meta"]["n_variants"]
    assert assert_results_agree(got, want) <= 1e-6


WRITERS = {
    "oracle_grid": (toracle, joracle),
    "discipline_grid": (tdisc, jdisc),
    "workload_grid": (twork, jwork),
    "fault_grid": (tfault, jfault),
    "park_grid": (tpark, jpark),
}


def written(mod, result, where):
    """The ``.csv`` and ``.md`` bytes ``mod.write_phase_diagram`` writes
    for ``result`` under ``where``."""
    csv_path, md_path = mod.write_phase_diagram(result, str(where))
    with open(csv_path, "rb") as f, open(md_path, "rb") as g:
        return f.read(), g.read()


@pytest.mark.parametrize("grid", list(WRITERS))
def test_writer_bytes_equal_reference(grid, tmp_path):
    """One result dict made by the reference's grid, written by both
    packages' writers: byte-identical CSV and Markdown."""
    port, ref = WRITERS[grid]
    _, want = cached(grid, **ONE_SHOT[grid])
    got_csv, got_md = written(port, want, tmp_path / "port")
    want_csv, want_md = written(ref, want, tmp_path / "ref")
    assert got_csv == want_csv and got_md == want_md
    assert got_csv.count(b"\n") == 1 + len(want["phase"])
    assert len(got_md) > 0


def test_writer_reads_the_port_result(tmp_path):
    """The port's own result dict goes through the reference's writer and
    the port's alike (the keys match), to the same bytes."""
    got, _ = cached("discipline_grid", **ONE_SHOT["discipline_grid"])
    assert written(tdisc, got, tmp_path / "port") == \
        written(jdisc, got, tmp_path / "ref")


#: The six grids that take ``shard``, at the CPU's smallest sizes (27-34
#: planned steps; the park grid's wake costs plan 136 at target_cs 1): a
#: split runs the plain versions once a shard, whatever its rows.
SHARDED = {
    "discipline_grid": dict(n_scenarios=2, target_cs=2),
    "workload_grid": dict(n_scenarios=1, target_cs=2),
    "fault_grid": dict(n_scenarios=1, target_cs=2),
    "park_grid": dict(n_scenarios=1, target_cs=1),
    "arrival_grid": dict(n_scenarios=1, target_cs=2),
    "refine_grid": dict(nx=2, ny=2, factor=2, target_cs=2,
                        thread_range=(2, 6), cs_range=(1e-6, 3e-5)),
}


def test_shard_true_raises_before_any_work(monkeypatch):
    """``shard=True`` at one forced shard runs the split and equals
    ``shard=False`` in every integer, winner and float, for each of the
    six grids; the meta records the split."""
    from repro_torch.device import ENV_SHARDS

    monkeypatch.setenv(ENV_SHARDS, "1")
    for grid, kw in SHARDED.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")    # step-cap notes, nan-means
            split, whole = (getattr(tsweep, grid)(
                shard=shard, device="cpu", verbose=False, **kw)
                for shard in (True, False))
        assert assert_results_agree(split, whole, rtol=0.0) == 0.0, grid
        if grid != "refine_grid":
            assert split["meta"]["n_devices"] == 1, grid
            assert (split["meta"]["sharded"],
                    whole["meta"]["sharded"]) == (True, False), grid


def test_variant_names_and_helpers_equal_reference():
    from repro_torch.configs import catalog as tcatalog

    assert [tsweep._variant_name(v)
            for v in tcatalog.lock_discipline_variants()] == \
        [jsweep._variant_name(v)
         for v in tcatalog.lock_discipline_variants()]
    assert tsweep.STREAM_AUTO == jsweep.STREAM_AUTO
    cols = tcatalog.sample_scenario_columns(40, seed=9)
    assert tsweep._scenario_feats(cols) == jsweep._scenario_feats(cols)
    keys = [(f["cs"], f["sub"]) for f in tsweep._scenario_feats(cols)]
    t_uniq, t_ids = tsweep._phase_cells(keys)
    j_uniq, j_ids = jsweep._phase_cells(keys)
    assert t_uniq == j_uniq
    np.testing.assert_array_equal(t_ids, j_ids)
    thr = np.random.default_rng(0).random(40 * 3)
    np.testing.assert_array_equal(
        tsweep._host_wins(thr, len(t_uniq), t_ids, 3),
        jsweep._host_wins(thr, len(j_uniq), j_ids, 3))
