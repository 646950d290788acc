"""The arithmetic the lock simulator's CUDA kernels write in another form
than the plain version, held to the form it replaces.

The kernels (``csrc/lock_sim_stages.cuh``, ``csrc/lock_sim_block.cu``) must
equal their plain versions bit for bit (ROADMAP.md C4), and they cannot run
here.  Where a kernel computes an expression of ``kernels/ref.py`` in
another form, the rewrite is restated below in float32 PyTorch and held,
on seeded operands, to the expression it replaces:

* ``frac1(x) = copysignf(x - truncf(x), x)`` for ``fmodf(x, 1.0f)``: bit for
  bit for every finite x, and equal to the plain version's floor modulo
  ``x % 1.0`` for x >= 0, the simulator's domain (``now2 / wl_period +
  phase``, over a 58 675-step horizon, past 2^23 and 2^24, subnormals);
* the open admission's ``rate * dt`` split once per launch, one value per
  burst gate, and read at the gate only on bursty rows;
* the counts of a mask's lanes ranked below a bound (park grants, the wake
  quota), taken from the rank's ballot, and the thread-id handoff taken
  without a row minimum;
* the sub-step that runs none of the five lane stages (budget exhaustion,
  wake completions, release, backoff polls, arrivals) when no lane meets
  one of their tests: on such rows the plain step changes no lane and no
  row counter, apart from retiring tickets and, on open rows, admitting and
  binding requests.
"""

import numpy as np
import pytest
import torch

# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro_torch.configs import catalog
from repro_torch.core import policy as P
from repro_torch.core import xdes
from repro_torch.core.policy import SimConfig
from repro_torch.kernels import ref

F32 = torch.float32
#: The arrival diagram's horizon at target_cs=50 (chip_smoke.py's
#: ``arrival_at_size``).
HORIZON = 58_675


def frac1(x):
    """The kernels' ``frac1`` (lock_sim_stages.cuh), in float32."""
    return torch.copysign(x - torch.trunc(x), x)


def _bits(x):
    return x.contiguous().view(torch.int32)


def _simulator_operands():
    """``now2 / wl_period + phase`` in the kernels' float32 order for every
    step of the horizon, on eight scenarios' rows of the arrival diagram:
    the admission's ``ar_phase`` and four threads' workload ``phase_u``."""
    cols = catalog.lock_arrival_columns(n_scenarios=8)
    arrs = P.encode_columns(cols)
    dt, _ = xdes.plan_schedule_columns(cols, 50)
    rows = np.arange(0, len(dt), 120)            # one row per scenario
    dt = torch.from_numpy(dt[rows])
    period = torch.from_numpy(np.asarray(arrs["wl_period"], np.float32)[rows])
    seed = torch.from_numpy(np.asarray(arrs["seed"])[rows]).to(torch.int64)
    phases = [ref.counter_uniform(ref.xor_salt(seed, P.AR_PHASE_SALT), 0, 0)]
    phases += [ref.counter_uniform(ref.xor_salt(seed, P.WL_PHASE_SALT), tid, 0)
               for tid in range(4)]
    i_f = torch.arange(HORIZON, dtype=torch.int32).to(F32)
    now2 = (i_f[None, :] + 1.0) * dt[:, None]                 # (rows, steps)
    x = torch.stack([now2 / period[:, None] + ph[:, None] for ph in phases])
    assert x.dtype == F32
    return x.reshape(-1), now2, period, phases


def _random_bits(n, seed, lo=0, hi=2**32):
    rng = np.random.default_rng(seed)
    b = rng.integers(lo, hi, n, dtype=np.uint64).astype(np.uint32)
    x = torch.from_numpy(b.view(np.int32)).view(F32)
    return x[torch.isfinite(x)]


def _operand_sets():
    sim = _simulator_operands()[0]
    big = torch.cat([
        torch.from_numpy(np.random.default_rng(1).uniform(
            2.0**23, 2.0**26, 100_000).astype(np.float32)),
        # the boundaries and their neighbours
        torch.tensor([2.0**23, 2.0**24, 2.0**25], dtype=F32),
        torch.nextafter(torch.tensor([2.0**23, 2.0**24], dtype=F32),
                        torch.tensor(0.0)),
        torch.nextafter(torch.tensor([2.0**23, 2.0**24], dtype=F32),
                        torch.tensor(float("inf")))])
    sub = _random_bits(100_000, 2, 1, 0x00800000)    # positive subnormals
    sub = torch.cat([sub, torch.tensor([0.0, 1.4e-45], dtype=F32)])
    return {"simulator": sim, "past_2_23": big, "subnormal": sub,
            "negative": -torch.cat([sim[:200_000], big, sub,
                                    torch.arange(1, 1000, dtype=F32)]),
            "random_bits": _random_bits(1_000_000, 3)}


OPERANDS = _operand_sets()


@pytest.mark.parametrize("name", sorted(OPERANDS))
def test_frac1_is_fmod_bit_for_bit(name):
    x = OPERANDS[name]
    assert torch.isfinite(x).all() and x.numel() > 0
    assert torch.equal(_bits(frac1(x)), _bits(torch.fmod(x, 1.0)))


@pytest.mark.parametrize("name", ["simulator", "past_2_23", "subnormal",
                                  "random_bits"])
def test_frac1_is_floor_modulo_on_non_negatives(name):
    x = OPERANDS[name]
    x = x[x >= 0]
    assert x.numel() > 0
    assert torch.equal(_bits(frac1(x)), _bits(torch.remainder(x, 1.0)))
    assert torch.equal(_bits(frac1(x)), _bits(x % 1.0))


def test_simulator_operands_span_the_horizon():
    x = OPERANDS["simulator"]
    # hundreds of burst cycles: the fractional part loses low bits as the
    # count grows, and x - trunc(x) stays exact there too
    assert x.min() >= 0 and x.max() > 200.0
    assert (frac1(x) != 0).float().mean() > 0.99


def test_burst_gate_equals_the_plain_gate():
    """The kernels' OFF gate ``frac1(now2 / period + phase) >= duty`` is
    ``policy.workload_off_gate`` (floor modulo) at every step."""
    _, now2, period, phases = _simulator_operands()
    for duty in (0.1, 0.25, 0.5, 0.9):
        d = torch.tensor(duty, dtype=F32)
        for ph in phases:
            got = frac1(now2 / period[:, None] + ph[:, None]) >= d
            want = P.workload_off_gate(now2, ph[:, None], period[:, None], d)
            assert want.dtype == F32
            assert torch.equal(got, want > 0)


def _arrival_rate(arrival, arr_rate, gate_on, burst):
    """The kernels' ``arrival_rate`` switch (lock_sim_stages.cuh)."""
    return torch.where(
        arrival == P.AR_POISSON, arr_rate * 1.0,
        torch.where(arrival == P.AR_BURSTY,
                    arr_rate * (1.0 + gate_on * (burst - 1.0)),
                    arr_rate * 0.0))


def test_admission_split_equals_the_per_step_count():
    rng = np.random.default_rng(5)
    n = 30_000
    arrival = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
    arr_rate = torch.from_numpy(rng.uniform(0.0, 3e6, n).astype(np.float32))
    burst = torch.from_numpy(rng.uniform(1.0, 16.0, n).astype(np.float32))
    dt = torch.from_numpy(rng.uniform(1e-8, 2e-6, n).astype(np.float32))
    u = ref.counter_uniform(
        torch.from_numpy(rng.integers(0, 2**32, n, dtype=np.uint64)),
        0, torch.from_numpy(rng.integers(0, 2**31, n)))
    assert u.dtype == F32 and (u >= 0).all() and (u < 1).all()
    split = {}
    for g in (0.0, 1.0):
        gate = torch.tensor(g, dtype=F32)
        m = P.arrival_rate_at(arrival, arr_rate, gate, burst) * dt
        assert m.dtype == F32
        # the kernels' switch is the plain masked select, bit for bit
        assert torch.equal(_bits(_arrival_rate(arrival, arr_rate, gate,
                                               burst) * dt), _bits(m))
        # ref.py's count from m, and the kernels' from the split of m
        mf = torch.floor(m)
        want = (mf + (u < (m - mf)).to(F32)).to(torch.int32)
        mf_k, fr_k = torch.floor(m), m - torch.floor(m)
        assert torch.equal((mf_k + (u < fr_k).to(F32)).to(torch.int32), want)
        assert (want > 0).any() and (want == 0).any()
        split[g] = _bits(m)
    # rows other than bursty do not read the gate
    not_bursty = arrival != P.AR_BURSTY
    assert torch.equal(split[0.0][not_bursty], split[1.0][not_bursty])
    assert not torch.equal(split[0.0][~not_bursty], split[1.0][~not_bursty])


# --------------------------------------------------------------------------
# Counts the kernels take from a rank instead of a second ballot
# --------------------------------------------------------------------------
def _rank_of(mask):
    """ref.py's ``rank_of``: ``cumsum - 1`` along the thread axis."""
    return torch.cumsum(mask.to(torch.int32), dim=-1).to(torch.int32) - 1


def _first_oh(mask):
    """ref.py's ``first_oh``: one-hot of the lowest tid in the mask."""
    T = mask.shape[-1]
    idx = torch.argmax(mask.to(torch.int32), dim=-1, keepdim=True)
    return (torch.arange(T) == idx) & mask.any(-1, keepdim=True)


@pytest.mark.parametrize("T", [8, 32, 128])
def test_rank_below_a_bound_counts_the_clamped_count(T):
    """``count(mask & (rank_of(mask) < p))`` (ref.py's park grants and its
    wake-quota selection) is ``max(0, min(count(mask), p))``, the kernels'
    form, for every p, negative ones included."""
    rng = np.random.default_rng(T)
    mask = torch.from_numpy(rng.random((4000, T)) < rng.random((4000, 1)))
    p = torch.from_numpy(rng.integers(-3, T + 3, (4000, 1)).astype(np.int32))
    want = (mask & (_rank_of(mask) < p)).sum(-1).to(torch.int32)
    got = torch.clamp(torch.minimum(mask.sum(-1).to(torch.int32), p[:, 0]),
                      min=0)
    assert torch.equal(got, want)
    assert (want == 0).any() and (want == mask.sum(-1)).any()


def test_handoff_by_thread_id_is_the_lowest_spinner():
    """With the key = tid (neither FIFO nor a random tie-break) ref.py's
    ``first_oh(spinners & (key == row_min(key)))`` is ``first_oh(spinners)``,
    which the kernels take without the row minimum."""
    rng = np.random.default_rng(11)
    T = 32
    spinners = torch.from_numpy(rng.random((4000, T)) < 0.2)
    spinners[0] = False                      # a row without a spinner
    tid = torch.arange(T, dtype=torch.int32).expand(4000, T)
    key = torch.where(spinners, tid, torch.tensor(ref.NO_TICKET))
    cand = spinners & (key == key.min(dim=-1, keepdim=True).values)
    assert torch.equal(_first_oh(cand), _first_oh(spinners))


# --------------------------------------------------------------------------
# The sub-step without lane events
# --------------------------------------------------------------------------
SHORT = (0.0, 3.7e-6)
LONG = (0.0, 80e-6)
WAKE = 8e-6


def _matrix(open_loop):
    """Every policy id x fault row, workloads and park costs riding along;
    open: the two open arrival rows at loads 0.6 and 2 with small queues."""
    rng = np.random.default_rng(7)
    cfgs = []
    workloads, faults = list(P.WORKLOAD_ROWS), list(P.FAULT_ROWS)
    for lock in sorted(P.POLICY_IDS):
        for flt in faults:
            i = len(cfgs)
            threads, cores = int(rng.integers(2, 9)), int(rng.integers(2, 9))
            kw = {}
            if open_loop:
                cs = SHORT if i % 2 else LONG
                cap = catalog.lock_arrival_capacity(dict(
                    cs_hi=cs[1], ncs_hi=SHORT[1], threads=threads,
                    cores=cores))
                kw = dict(arrival=("poisson", "bursty")[i % 2],
                          arrival_rate=(0.6, 2.0)[(i // 2) % 2] * cap,
                          queue_cap=int(rng.choice([2, 16])), slo=2e-5)
            cfgs.append(SimConfig(
                lock, threads=threads, cores=cores,
                cs=SHORT if i % 2 else LONG, ncs=SHORT, wake_latency=WAKE,
                seed=int(rng.integers(0, 1000)),
                workload=workloads[i % len(workloads)], wl_period=8e-5,
                fault=flt, fault_rate=0.0 if flt == "none" else 0.25,
                park_cost=(0.25, 1.0, 16.0)[i % 3],
                tie_break=("id", "random")[i % 2], **kw))
    arrs = P.encode_configs(cfgs)
    arrs["dt"], _ = xdes.plan_schedule(cfgs, 20)
    return xdes.columns_from_numpy(arrs, "cpu")


def _no_event(st, rem, wake_at, now_teps, active, budget_f, backoff_f):
    """The kernels' ``any_event`` negated, per row."""
    rem_due = rem <= ref.REM_EPS
    wk_due = wake_at <= now_teps[:, None]
    spin = st == P.SPIN
    ev = ((rem_due & ((st == P.CS) | ((st == P.NCS) & active)
                      | (spin & budget_f[:, None])))
          | (wk_due & ((st == P.WAKING) | (spin & backoff_f[:, None]))))
    return ~ev.any(-1)


@pytest.mark.parametrize("open_loop", [False, True])
def test_step_without_lane_events_changes_no_lane(open_loop):
    T, n_steps = 8, 400
    cols = _matrix(open_loop)
    C = cols["policy"].shape[0]
    flags = P.discipline_flags(cols["policy"])
    fifo_f, budget_f, backoff_f = (flags[1] > 0, flags[2] > 0, flags[7] > 0)
    active = torch.arange(T)[None, :] < cols["threads"][:, None]
    prm = tuple(cols[f] for f in xdes._PRM_FIELDS)
    dt = cols["dt"]
    state = xdes._init_state(cols, T, open_loop)
    spin_cpu = state[16]
    ostate = state[17:] if open_loop else None
    state = state[:16]
    quiet_rows = busy_rows = 0
    for step in range(n_steps):
        i = torch.tensor(step, dtype=torch.int32)
        i_f = i.to(F32)
        now2 = (i_f + 1.0) * dt
        st = state[0]
        rem, _ = ref.lock_sim_step_ref(st, state[1], cols["alpha"],
                                       cols["cores"], dt, budget_f)
        rem = ref.fault_rewind(st, rem, cols["alpha"], cols["cores"], dt,
                               i_f * dt, cols["seed"], cols["fault"],
                               cols["flt_rate"], cols["flt_scale"])
        quiet = _no_event(st, rem, state[2], now2 + dt * 1e-3, active,
                          budget_f, backoff_f)
        out = ref.lock_transitions_ref(st, rem, *state[2:], now2, i, *prm,
                                       open_state=ostate)
        new, onew = out[:16], out[16:]
        q = quiet
        queued = (st == P.SPIN) | (fifo_f[:, None] & ((st == P.SLEEP)
                                                      | (st == P.WAKING)))
        retired = torch.where(queued, state[6], ref.NO_TICKET)
        bound = torch.zeros_like(st, dtype=torch.bool)
        if open_loop:
            # binding turns free slots (DONE) into NCS, nothing else
            bound = (st == P.DONE) & (new[0] == P.NCS)
            for name, a, b in zip(ref.OPEN_STATE, ostate, onew):
                if name in ("hist", "departed", "slo_viol", "lat_sum"):
                    assert torch.equal(a[q], b[q]), name
        keep = q[:, None] & ~bound
        for name, a, b in zip(ref.TRANSITION_THREAD_STATE, (st, rem,
                                                            *state[2:8]),
                              new[:8]):
            want = retired if name == "ticket" else a
            assert torch.equal(want[keep], b[keep]), (step, name)
        for name, a, b in zip(ref.TRANSITION_CONFIG_STATE, state[8:],
                              new[8:]):
            assert torch.equal(a[q], b[q]), (step, name)
        quiet_rows += int(q.sum())
        busy_rows += int((~q).sum())
        state, ostate = new, (onew if open_loop else None)
    # both kinds of step occur, the quiet one most often
    assert quiet_rows > busy_rows > 0.02 * C * n_steps
