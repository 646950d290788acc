"""What can be held about the CUDA kernel without a GPU.

The kernel cannot call the Python row functions, so every registry id,
salt and flag is written out again in ``csrc/lock_sim_consts.cuh``.  These
tests parse that header and hold it to the port's ``policy.py`` — a
registry row added without a kernel arm fails here — and pin the package
rules: the port imports neither ``jax`` nor ``repro``, and a CUDA-device
call without CUDA raises instead of running on the CPU.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro_torch.core import policy as P
from repro_torch.core import xdes
from repro_torch.kernels import lock_sim as K
from repro_torch.kernels import lm_lib, ref

ROOT = Path(__file__).resolve().parents[1]
_DECL = re.compile(
    r"^constexpr\s+(int|unsigned|float)\s+(\w+)\s*=\s*([^;]+);", re.M)


def _parse_consts():
    out = {}
    for ctype, name, value in _DECL.findall(
            (K.CSRC / "lock_sim_consts.cuh").read_text()):
        value = value.strip()
        if ctype == "float":
            out[name] = float(value.rstrip("f"))
        else:
            out[name] = int(value.rstrip("u"), 0)
    return out


CONSTS = _parse_consts()

POLICY_CONST = {"tas": "TAS", "ttas": "TTAS", "mcs": "MCS", "sleep": "SLEEP",
                "adaptive": "ADAPTIVE", "mutable": "MUTABLE", "fifo": "FIFO",
                "fissile": "FISSILE", "hapax": "HAPAX",
                "ttas_backoff": "TTAS_BACKOFF"}
FLAG_CONST = dict(zip(P.DISCIPLINE_FLAG_ATTRS,
                      ("F_HANDOFF", "F_FIFO", "F_BUDGET", "F_W2S",
                       "F_REPARK", "F_WINDOWED", "F_BSCALED", "F_BACKOFF")))


def test_header_parses():
    assert len(CONSTS) > 70
    src = (K.CSRC / "lock_sim_block.cu").read_text()
    assert '#include "lock_sim_consts.cuh"' in src
    assert "lock_sim_block_launch" in src
    # every kernel source sees the same constants and shared stages, and
    # defines the C entry point its wrapper loads
    for name in K.KERNEL_SOURCES:
        src = (K.CSRC / name).read_text()
        assert '#include "lock_sim_consts.cuh"' in src, name
        assert '#include "lock_sim_stages.cuh"' in src, name
        entry = name.removesuffix(".cu") + "_launch"
        assert re.search(r'extern "C" int ' + entry + r"\(", src), name
        assert callable(getattr(K, name.removesuffix(".cu"))), name
    # every header belongs to one library: the simulator's or the LM's
    assert set(K.KERNEL_HEADERS).isdisjoint(lm_lib.HEADERS)
    assert set(K.KERNEL_HEADERS) | set(lm_lib.HEADERS) == \
        {p.name for p in K.CSRC.glob("*.cuh")}
    # every source belongs to one library: the simulator's or the LM's
    assert set(K.KERNEL_SOURCES).isdisjoint(lm_lib.SOURCES)
    assert set(K.KERNEL_SOURCES) | set(lm_lib.SOURCES) == \
        {p.name for p in K.CSRC.glob("*.cu")}


def test_lm_library_binds_every_entry_point():
    """Every ``extern "C"`` function the LM sources define has its ctypes
    argument types in ``lm_lib``: the launches (a stream last) in
    SIGNATURES, the launch-free queries in QUERIES; a function another LM
    source declares is that source's own callee (K5's tensor-core launch),
    not bound.  ``lm_lib`` binds nothing the sources lack."""
    defined, declared = set(), set()
    for name in lm_lib.SOURCES:
        src = (K.CSRC / name).read_text()
        for fn, end in re.findall(r'extern "C" int (\w+)\([^;{]*\)\s*([;{])',
                                  src):
            (defined if end == "{" else declared).add(fn)
    assert declared <= defined
    assert defined - declared == set(lm_lib.SIGNATURES) | set(lm_lib.QUERIES)
    assert set(lm_lib.SIGNATURES).isdisjoint(lm_lib.QUERIES)
    assert all(fn.endswith("_launch") for fn in lm_lib.SIGNATURES)
    assert not any(fn.endswith("_launch") for fn in lm_lib.QUERIES)
    assert {"mamba_scan_occupancy", "rmsnorm_occupancy",
            "rwkv6_scan_occupancy"} <= set(lm_lib.QUERIES)
    assert "lm_empty_launch" in lm_lib.SIGNATURES


@pytest.mark.parametrize("name,value", [
    ("ST_NCS", P.NCS), ("ST_CS", P.CS), ("ST_SPIN", P.SPIN),
    ("ST_SLEEP", P.SLEEP_ST), ("ST_WAKING", P.WAKING), ("ST_DONE", P.DONE),
    ("BO_SALT", P.BO_SALT), ("WL_PHASE_SALT", P.WL_PHASE_SALT),
    ("WL_SPREAD_SALT", P.WL_SPREAD_SALT), ("TB_SALT", P.TB_SALT),
    ("FLT_GATE_SALT", P.FLT_GATE_SALT), ("FLT_WAKE_SALT", P.FLT_WAKE_SALT),
    ("FLT_MAG_SALT", P.FLT_MAG_SALT), ("EWMA_ONE", P.EWMA_ONE),
    ("EWMA_SHIFT", P.EWMA_SHIFT), ("BO_CAP", P.BO_CAP),
    ("NO_TICKET", ref.NO_TICKET), ("AR_CLOSED", P.AR_CLOSED),
    ("MAX_T", K.MAX_THREADS), ("AR_SALT", P.AR_SALT),
    ("AR_PHASE_SALT", P.AR_PHASE_SALT), ("QUEUE_MAX", P.QUEUE_MAX),
    ("LAT_NBINS", P.LAT_NBINS),
    ("LAT_BINS_PER_OCTAVE", P.LAT_BINS_PER_OCTAVE),
])
def test_scalar_constants_equal(name, value):
    assert CONSTS[name] == value


def test_rem_eps_equal_in_float32():
    assert np.float32(CONSTS["REM_EPS"]) == np.float32(ref.REM_EPS)
    assert np.float32(CONSTS["LAT_BIN0"]) == np.float32(P.LAT_BIN0)


@pytest.mark.parametrize("prefix,table", [
    ("POLICY_", {POLICY_CONST[n]: i for n, i in P.POLICY_IDS.items()}),
    ("ORACLE_", {n.upper(): i for n, i in P.ORACLE_IDS.items()}),
    ("WL_", {n.upper(): i for n, i in P.WORKLOAD_IDS.items()}),
    ("FAULT_", {n.upper(): i for n, i in P.FAULT_IDS.items()}),
    ("TB_", {n.upper(): i for n, i in P.TIE_BREAK_IDS.items()}),
    ("AR_", {n.upper(): i for n, i in P.ARRIVAL_IDS.items()}),
])
def test_id_tables_equal(prefix, table):
    """Every registry id has a constant of the same value, and the header
    holds no id the registry lacks."""
    salts = {"WL_PHASE_SALT", "WL_SPREAD_SALT", "TB_SALT", "AR_SALT",
             "AR_PHASE_SALT"}
    mine = {k[len(prefix):]: v for k, v in CONSTS.items()
            if k.startswith(prefix) and k not in salts}
    assert mine == table


@pytest.mark.parametrize("column,count,registry", [
    ("policy", "N_POLICY", P.POLICY_IDS), ("oracle", "N_ORACLE", P.ORACLE_IDS),
    ("workload", "N_WORKLOAD", P.WORKLOAD_IDS),
    ("fault", "N_FAULT", P.FAULT_IDS), ("tb", "N_TIE_BREAK", P.TIE_BREAK_IDS),
    ("arrival", "N_ARRIVAL", P.ARRIVAL_IDS),
])
def test_wrapper_admits_exactly_the_registry(column, count, registry):
    assert K.KERNEL_IDS[column] == frozenset(registry.values())
    assert CONSTS[count] == len(registry)
    if column == "oracle":          # oracle_step's own check
        ids = torch.tensor(sorted(registry.values()), dtype=torch.int32)
        K.check_oracle_ids(ids)
        with pytest.raises(ValueError, match="oracle ids"):
            K.check_oracle_ids(torch.cat([ids, ids[-1:] + 1]))


def test_wrapper_admits_only_the_closed_arrival_row():
    """The closed launch admits only the closed arrival row; the open one
    (``open_state`` given) admits every ARRIVAL_ROWS id."""
    assert K.KERNEL_IDS["arrival"] == frozenset(
        r.aid for r in P.ARRIVAL_ROWS.values())
    col = lambda *v: torch.tensor(v, dtype=torch.int32)
    ids = dict(policy=col(0, 0), oracle=col(0, 0), workload=col(0, 0),
               fault=col(0, 0), tb=col(0, 0))
    for aid in sorted(P.ARRIVAL_IDS.values()):
        K.check_id_columns(**ids, arrival=col(P.AR_CLOSED, aid),
                           open_loop=True)
        if aid != P.AR_CLOSED:
            with pytest.raises(ValueError, match="closed launch"):
                K.check_id_columns(**ids, arrival=col(P.AR_CLOSED, aid))


@pytest.mark.parametrize("lock", sorted(P.POLICY_IDS))
def test_discipline_row_word(lock):
    """ROW_<LOCK> = flags | arrival rule << 8 | quota rule << 12, derived
    here from the registry row the policy id belongs to."""
    row = P.POLICY_ROW[P.POLICY_IDS[lock]]
    flags = sum(CONSTS[FLAG_CONST[a]] for a in P.DISCIPLINE_FLAG_ATTRS
                if getattr(row, a))
    arrive = CONSTS["ARRIVE_" + row.arrival_sleeps.__name__
                    .removeprefix("_arrive_").upper()]
    quota = CONSTS["QUOTA_" + row.quota.__name__
                   .removeprefix("_quota_").upper()]
    assert CONSTS["ROW_" + POLICY_CONST[lock]] == \
        flags | arrive << 8 | quota << 12
    assert [CONSTS[FLAG_CONST[a]] for a in P.DISCIPLINE_FLAG_ATTRS] == \
        [1 << i for i in range(8)]


def test_kernel_context_is_block_context_minus_open_columns():
    names = tuple(n for n, _ in K._KERNEL_CTX)
    open_cols = ("arrival", "arr_rate", "q_cap", "slo")
    assert names == tuple(n for n in ref.BLOCK_CONTEXT
                          if n not in open_cols)
    # the open variant's four columns follow them in the C struct
    assert tuple(n for n, _ in K._OPEN_CTX) == open_cols
    assert sorted(names + open_cols) == sorted(ref.BLOCK_CONTEXT)
    assert ref.BLOCK_CONTEXT[5:] == ref.TRANSITION_CONTEXT[2:]
    # the transition kernel takes the same columns from policy on
    assert K._TRANSITION_CTX == K._KERNEL_CTX[5:] + K._OPEN_CTX
    assert sorted(n for n, _ in K._TRANSITION_CTX) == \
        sorted(ref.TRANSITION_CONTEXT[2:])
    assert xdes._PRM_FIELDS == ref.TRANSITION_CONTEXT[2:]
    assert K.NVCC_FLAGS.count("-fmad=false") == 1
    assert "arch=compute_90a,code=sm_90a" in K.NVCC_FLAGS
    assert not any("fast" in f for f in K.NVCC_FLAGS)


def test_check_id_columns():
    col = lambda *v: torch.tensor(v, dtype=torch.int32)
    ok = dict(policy=col(0, 9), oracle=col(0, 3), workload=col(3, 0),
              fault=col(4, 0), tb=col(0, 1), arrival=col(0, 0))
    K.check_id_columns(**ok)
    for name, bad in (("policy", 10), ("oracle", 4), ("workload", -1),
                      ("fault", 5), ("tb", 2)):
        with pytest.raises(ValueError, match=name):
            K.check_id_columns(**{**ok, name: col(0, bad)})
    with pytest.raises(ValueError, match="closed launch"):
        K.check_id_columns(**{**ok, "arrival": col(0, 1)})
    K.check_id_columns(**{**ok, "arrival": col(0, 2)}, open_loop=True)
    with pytest.raises(ValueError, match="arrival"):
        K.check_id_columns(**{**ok, "arrival": col(0, 3)}, open_loop=True)


def test_import_pulls_in_neither_jax_nor_repro():
    code = ("import sys; import repro_torch; import repro_torch.core.xdes; "
            "import repro_torch.core.policy; import repro_torch.kernels.ref; "
            "import repro_torch.kernels.lock_sim; "
            "from repro_torch.kernels.lock_sim import lock_sim_block, "
            "lock_sim_step, lock_transitions_step, oracle_step; "
            "import repro_torch.configs.catalog; "
            "import repro_torch.core.stream; "
            "import repro_torch.core.mutlock; "
            "import repro_torch.checkpoint.manager; "
            "import repro_torch.configs.base; import repro_torch.models; "
            "import repro_torch.models.convert; import repro_torch.serve; "
            "import repro_torch.launch.serve; "
            "import repro_torch.kernels.ops; "
            "import repro_torch.kernels.flash_attention; "
            "import repro_torch.kernels.rmsnorm; "
            "import repro_torch.kernels.rwkv6_scan; "
            "import repro_torch.kernels.mamba_scan; "
            "import repro_torch.models.mamba; "
            "import repro_torch.models.moe; "
            "import repro_torch.core.window; "
            "import repro_torch.bench; import repro_torch.bench.sweep; "
            "import repro_torch.bench.oracle_ablation; "
            "import repro_torch.bench.discipline_diagram; "
            "import repro_torch.bench.workload_diagram; "
            "import repro_torch.bench.arrival_diagram; "
            "import repro_torch.bench.fault_diagram; "
            "import repro_torch.bench.park_diagram; "
            "from repro_torch.serve import SCHED_POLICY_LOCKS, "
            "SchedScenario, sample_sched_scenarios, xdes_policy_sweep; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
            "m.startswith('repro.') or m == 'triton']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={**os.environ,
                               "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_import_of_jax_or_repro_in_the_sources():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) >= 16
    assert not [f for f in files if pat.search(f.read_text())]


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = P.SimConfig("mutable", 4, 4, (0.0, 3.7e-6), (0.0, 3.7e-6))
    for device in (None, "cuda", torch.device("cuda:0")):
        with pytest.raises(RuntimeError, match="CUDA"):
            xdes.simulate_batch([cfg], n_steps=8, device=device)
    with pytest.raises(RuntimeError, match="CUDA"):
        xdes.columns_from_numpy({"x": np.zeros(2, np.float32)}, None)
    # the serving path: parameters, caches, the engine and the CLI
    from repro_torch import models
    from repro_torch.configs import base, catalog
    from repro_torch.launch import serve
    from repro_torch.serve import DecodeEngine
    tiny = catalog.tiny(base.get_config("llama3.2-1b"))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            models.init_params(tiny, device=device)
        with pytest.raises(RuntimeError, match="CUDA"):
            models.init_cache(tiny, 1, 8, device=device)
    params = models.init_params(tiny, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(tiny, params, max_slots=1, max_seq=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--tiny", "--requests", "1"])


def test_sweep_layer_without_cuda_raises(tmp_path):
    """Every grid, every CLI of ``repro_torch.bench`` and the
    scheduler-policy sweep run on the card unless asked for the CPU:
    without CUDA they raise before writing anything."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    import importlib

    from repro_torch.bench import sweep
    from repro_torch.serve import sample_sched_scenarios, xdes_policy_sweep
    for grid in ("fig3_batched", "scenario", "oracle_grid",
                 "discipline_grid", "workload_grid", "arrival_grid",
                 "fault_grid", "park_grid", "refine_grid"):
        for device in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA"):
                getattr(sweep, grid)(device=device, verbose=False)
    for name in ("sweep", "oracle_ablation", "discipline_diagram",
                 "workload_diagram", "arrival_diagram", "fault_diagram",
                 "park_diagram"):
        cli = importlib.import_module(f"repro_torch.bench.{name}")
        for backend in ("kernel", "ref"):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.main(["--scenarios", "1", "--target-cs", "5",
                          "--backend", backend,
                          "--out", str(tmp_path / "out" / "r.json")])
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        xdes_policy_sweep(sample_sched_scenarios(2), target_cs=5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Argument checks that run before any launch, driven with meta
    tensors (a CUDA device type without a CUDA runtime)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfgs = [P.SimConfig("mutable", 4, 4, (0.0, 3.7e-6), (0.0, 3.7e-6))]
    arrs = P.encode_configs(cfgs)
    arrs["dt"], _ = xdes.plan_schedule(cfgs, 10)
    cols = xdes.columns_from_numpy(arrs, "cpu")
    state = xdes._init_state(cols, 4)
    args = (cols["alpha"], cols["cores"],
            P.discipline_flags(cols["policy"])[2] > 0,
            *(cols[f] for f in xdes._PRM_FIELDS))
    with pytest.raises(ValueError, match="11 OPEN_STATE"):
        K.lock_sim_block(*state, 0, *args, n_sub_steps=4, open_state=())
    meta = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        K.lock_sim_block(*map(meta, state), 0, *map(meta, args),
                         n_sub_steps=4)
    # the CPU path never counts a launch
    before = K.lock_sim_block.launches
    out = K.lock_sim_block(*state, 0, *args, n_sub_steps=4, limit=3)
    assert K.lock_sim_block.launches == before and len(out) == 17
