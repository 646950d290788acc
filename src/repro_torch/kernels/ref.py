"""Plain PyTorch versions of the port's kernels: the lock simulator's and,
at the end, the language model's (:func:`flash_attention_ref`,
:func:`rmsnorm_ref`).

These are *definitions*, not fast paths: each function is the eager-tensor
counterpart of the function of the same name in ``repro/kernels/ref.py``,
argument order for argument order.  The CPU tests run them, the wrappers in
:mod:`repro_torch.kernels.lock_sim` fall to them for CPU tensors only, and
``chip_smoke.py`` holds the CUDA kernel against them on the card.

Storage types.  Thread and config state is int32 / float32.  ``ctr`` and
``seed`` — uint32 in the reference — are stored as **int32 bit patterns**
(``torch.uint32`` has no usable arithmetic): :func:`counter_uniform` widens
them to int64, masks to 32 bits after every multiply, and shifts only
non-negative values, so the hash is bit-identical to the uint32 one.  The
CUDA kernel reads the same int32 buffers as ``unsigned``.

Arithmetic.  Every float expression is written op by op in the reference's
association (``lo + u * (hi - lo)`` is a multiply then an add, never an
``addcmul``), because a one-ulp difference in ``rem`` or ``wake_at`` flips
a ``<=`` test and forks the trajectory; the kernel is compiled with
``-fmad=false`` for the same reason.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import policy as P

#: Residual work (CPU-seconds) under which a CS/NCS counts as finished.
REM_EPS = 1e-9
#: Retired-ticket sentinel (no thread ever draws this many tickets).
NO_TICKET = 2**31 - 1

#: Canonical argument order of the transition boundary: per-thread (C, T)
#: state, per-config (C,) state, then the per-config context columns.
TRANSITION_THREAD_STATE = ("st", "rem", "wake_at", "slept", "spun", "ctr",
                           "ticket", "completed_pt")
TRANSITION_CONFIG_STATE = ("sws", "cnt", "ewma", "wuc", "permits", "nticket",
                           "completed", "wake_count")
TRANSITION_CONTEXT = ("now2", "stepi", "policy", "threads", "dt", "wake",
                      "cs_lo", "cs_hi", "ncs_lo", "ncs_hi", "k", "sws_max",
                      "spin_budget", "seed", "oracle", "workload",
                      "wl_period", "wl_duty", "wl_burst", "wl_spread",
                      "arrival", "arr_rate", "q_cap", "slo", "tb",
                      "fault", "flt_rate", "flt_scale", "park_cost")

#: Context columns of the block boundary, after the per-step state: the GPS
#: advance inputs, then the transition context minus ``now2`` (recomputed
#: inside the loop as ``(step0 + s + 1) * dt`` — the exact expression of
#: the per-step path, so blocked and per-step rollouts are bit-identical).
BLOCK_CONTEXT = ("step0", "limit", "alpha", "cores", "has_budget",
                 "policy", "threads", "dt", "wake", "cs_lo", "cs_hi",
                 "ncs_lo", "ncs_hi", "k", "sws_max", "spin_budget", "seed",
                 "oracle", "workload", "wl_period", "wl_duty", "wl_burst",
                 "wl_spread", "arrival", "arr_rate", "q_cap", "slo", "tb",
                 "fault", "flt_rate", "flt_scale", "park_cost")

#: The 17-array carry of the block boundary, in argument order.
BLOCK_STATE = TRANSITION_THREAD_STATE + TRANSITION_CONFIG_STATE \
    + ("spin_cpu",)

#: Open-loop state appended after the closed carry (spin_cpu), present
#: only when a batch runs the open-loop engine: ``req_t`` (C, T) f32
#: arrival time of the request bound to each thread slot (-1 when free),
#: ``qbuf`` (C, QUEUE_MAX) f32 ring buffer of queued arrival times,
#: ``hist`` (C, LAT_NBINS) i32 latency histogram, then (C,) counters:
#: queue head / length, arrived / shed / departed / SLO-violation counts
#: (i32), latency sum and queue+service occupancy time-integral (f32) —
#: the exact Little's-law pair.
OPEN_STATE = ("req_t", "qbuf", "hist", "qhead", "qlen", "arrived", "shed",
              "departed", "slo_viol", "lat_sum", "occ_int")

_M32 = 0xFFFFFFFF


def _i32(x):
    """Cast a row function's int64 result back to the int32 state type."""
    return x.to(torch.int32)


def _u32(x):
    """A uint32 value (int32 bit pattern, int64, or Python int) as a
    non-negative int64."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def xor_salt(seed, salt: int):
    """``seed ^ salt`` on uint32 values, whatever the storage of ``seed``:
    the result is the non-negative int64 form that
    :func:`counter_uniform` takes."""
    return _u32(seed) ^ (salt & _M32)


def counter_uniform(seed, tid, ctr):
    """Counter-based RNG: uniform [0,1) per (config, thread, event) from a
    splitmix-style avalanche — deterministic, stateless, replayable per
    cell independently of batch composition.

    ``seed`` and ``ctr`` are uint32 values in any storage (int32 bit
    patterns, non-negative int64, Python ints); the arithmetic runs in
    int64 masked to 32 bits, and the final uint32 -> float32 conversion
    rounds to nearest, as the reference's does."""
    x = _u32(seed) ^ ((_u32(tid) * 0x9E3779B9) & _M32) \
        ^ ((((_u32(ctr) + 1) & _M32) * 0x85EBCA6B) & _M32)
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    x = x ^ (x >> 16)
    return x.to(torch.float32) * (2.0 ** -32)


# --------------------------------------------------------------------------
# Workload rows (repro_torch.core.policy.WORKLOAD_ROWS) — the hold-time
# stage of the kernel boundary.
# --------------------------------------------------------------------------
def workload_state(seed, tid, now, wl_period, wl_duty, wl_spread):
    """Per-(config, thread) workload state at time ``now``.

    Returns ``(phase_u, gate_off, tscale)``: the thread's persistent
    duty-cycle phase uniform, its 0/1 OFF-phase gate at ``now``, and its
    persistent heterogeneity scale.  The two uniforms come from salted
    counter streams (WL_PHASE_SALT / WL_SPREAD_SALT), so they never collide
    with the event-draw stream and replay identically per cell."""
    phase_u = counter_uniform(xor_salt(seed, P.WL_PHASE_SALT), tid, 0)
    spread_u = counter_uniform(xor_salt(seed, P.WL_SPREAD_SALT), tid, 0)
    gate_off = P.workload_off_gate(now, phase_u, wl_period, wl_duty)
    tscale = P.workload_thread_scale(spread_u, wl_spread)
    return phase_u, gate_off, tscale


def workload_draw(u, lo, hi, is_ncs, workload, gate_off, tscale, wl_burst):
    """One workload-row hold-time draw from the uniform ``u``.

    ``is_ncs`` is a static 0/1 flag (CS vs NCS/arrival-gap draw); the
    exponential deviate for the jitter row is only materialized on the NCS
    path.  The deviate clamps ``u`` below 1 so that ``-log1p(-u)`` stays
    finite and the masked row dispatch never meets ``0 * inf``."""
    base = lo + u * (hi - lo)
    expd = ((0.5 * (lo + hi))
            * (-torch.log1p(-torch.clamp(u, max=1.0 - 2.0 ** -24)))
            if is_ncs else base)
    return P.workload_hold(workload, is_ncs, base, expd, gate_off, tscale,
                           wl_burst)


def workload_init_rem(seed, tid, ctr0, ncs_lo, ncs_hi, workload, wl_period,
                      wl_duty, wl_burst, wl_spread, arrival_phase):
    """The initial per-thread NCS draw (every thread starts in NCS),
    workload-modulated at ``now = 0``, plus the seeded per-thread
    arrival-order stagger of up to ``arrival_phase`` mean-NCS lengths."""
    u0 = counter_uniform(seed, tid, ctr0)
    phase_u, gate_off, tscale = workload_state(seed, tid, 0.0, wl_period,
                                               wl_duty, wl_spread)
    rem0 = workload_draw(u0, ncs_lo, ncs_hi, 1, workload, gate_off, tscale,
                         wl_burst)
    return rem0 + phase_u * arrival_phase * (0.5 * (ncs_lo + ncs_hi))


def _gps_rates(tstate, alpha, cores):
    """Masks and per-config rates shared by the advance and the rewind."""
    is_cs = tstate == P.CS
    is_ncs = tstate == P.NCS
    is_spin = tstate == P.SPIN
    n_run = (is_cs | is_ncs | is_spin).sum(-1).to(torch.float32)
    n_spin = is_spin.sum(-1).to(torch.float32)
    rate = torch.clamp(cores / torch.clamp(n_run, min=1.0), max=1.0)
    holder_rate = rate / (1.0 + alpha * n_spin)
    return is_cs, is_ncs, is_spin, n_spin, rate, holder_rate


def lock_sim_step_ref(tstate, rem, alpha, cores, dt, has_budget):
    """One generalized-processor-sharing advance of the batched lock sim.

    Every runnable thread advances at rate ``min(1, cores / n_runnable)``;
    the CS holder is additionally slowed by cache-coherency pressure
    ``1 / (1 + alpha * n_spinners)``; spinners burn CPU, and budgeted
    disciplines' spinners consume their spin budget.

    tstate (C, T) int32, rem (C, T) f32; alpha, cores, dt (C,) f32;
    has_budget (C,) bool.  Returns ``(rem', spin_burn)`` with spin_burn
    (C,) f32 — the CPU-seconds burnt spinning this step.

    ``spin_burn`` is ``n_spin * d_rate``, the closed form of the
    reference's lane sum ``sum_T where(spin, d_rate, 0)``: every spinner
    of a row burns the same ``d_rate``, and a float sum over T lanes
    depends on the order a backend adds them in.  The product is
    order-free, so the CUDA kernel and this version agree bit for bit; it
    differs from the reference's sum by rounding only (rtol 1e-6)."""
    is_cs, is_ncs, is_spin, n_spin, rate, holder_rate = _gps_rates(
        tstate, alpha, cores)
    zero = rem.new_zeros(())
    d_rate = dt * rate
    burn = torch.where(is_spin, d_rate[:, None], zero)
    dec = (torch.where(is_cs, (dt * holder_rate)[:, None], zero)
           + torch.where(is_ncs, d_rate[:, None], zero)
           + torch.where(has_budget[:, None], burn, zero))
    return rem - dec, n_spin * d_rate


def fault_rewind(st, rem, alpha, cores, dt, now_start, seed, fault,
                 flt_rate, flt_scale):
    """Fault-row progress theft for one timestep (FAULT_ROWS dispatch).

    Recomputes the GPS progress each CS/NCS thread made during the step
    that :func:`lock_sim_step_ref` just applied (from the SAME pre-step
    ``st``) and gives the stolen fraction back to ``rem``.  Windows are
    ``flt_scale`` seconds; the per-(thread, window) gate uniform comes from
    the FLT_GATE_SALT counter stream.  Applied through
    ``where(giveback > 0)``, so a fault-free config's ``rem`` passes
    through untouched.  ``now_start`` is the step's START time ``i * dt``
    (scalar or (C,))."""
    C, T = st.shape
    col = lambda v: v[:, None]
    is_cs, is_ncs, _, _, rate, holder_rate = _gps_rates(st, alpha, cores)
    zero = rem.new_zeros(())
    prog = (torch.where(is_cs, (dt * holder_rate)[:, None], zero)
            + torch.where(is_ncs, (dt * rate)[:, None], zero))
    tidb = torch.arange(T, dtype=torch.int32, device=st.device) \
        .expand(C, T)
    win = torch.floor(now_start / flt_scale).to(torch.int32)
    winT = win[:, None] if win.ndim else win
    gate_u = counter_uniform(col(xor_salt(seed, P.FLT_GATE_SALT)), tidb,
                             winT)
    scale = P.fault_progress_scale(col(fault), is_cs * 1.0, gate_u,
                                   col(flt_rate))
    giveback = prog * (1.0 - scale)
    return torch.where(giveback > 0.0, rem + giveback, rem)


def lock_transitions_ref(st, rem, wake_at, slept, spun, ctr, ticket,
                         completed_pt, sws, cnt, ewma, wuc, permits,
                         nticket, completed, wake_count,
                         now2, stepi, policy, threads, dt, wake, cs_lo,
                         cs_hi, ncs_lo, ncs_hi, k, sws_max, spin_budget,
                         seed, oracle, workload, wl_period, wl_duty,
                         wl_burst, wl_spread, arrival, arr_rate, q_cap,
                         slo, tb, fault, flt_rate, flt_scale, park_cost, *,
                         open_state=None):
    """One transition step for a (C, T) block of configurations.

    Stages, in the order the event-driven DES resolves a timestep:
    [open-loop admission] -> budget exhaustion -> wake completions -> CS
    release/handoff [+ open-loop departure] -> backoff polls -> arrivals
    -> ticket retire [-> open-loop binding + occupancy].  Per-thread state
    is (C, T) int32 / f32 (``slept``/``spun`` 0/1, ``ticket``
    :data:`NO_TICKET` when not queued, ``ctr`` an int32 bit pattern);
    per-config state and context are (C,) vectors; ``stepi`` is the
    global step index (int or (C,) int32), the counter of the per-step
    RNG streams.  Returns the 16 updated state arrays in canonical order
    (:data:`TRANSITION_THREAD_STATE` + :data:`TRANSITION_CONFIG_STATE`),
    plus the 11 :data:`OPEN_STATE` arrays when ``open_state`` is given.
    ``arrival``, ``arr_rate``, ``q_cap`` and ``slo`` are read by the open
    stages only; a closed config inside an open batch takes every open
    stage as an exact masked no-op."""
    C, T = st.shape
    dev = st.device
    f32, i32 = torch.float32, torch.int32
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    i0 = torch.zeros((), dtype=i32, device=dev)
    i1 = torch.ones((), dtype=i32, device=dev)
    no_ticket = torch.tensor(NO_TICKET, dtype=i32, device=dev)
    tid = torch.arange(T, dtype=i32, device=dev)[None, :]      # (1, T)
    tidb = tid.expand(C, T)
    col = lambda v: v[:, None]                                 # (C,) -> (C,1)
    active = tid < col(threads)
    (hand_f, fifo_f, budget_f, w2s_f, repark_f,
     win_f, bscale_f, backoff_f) = map(_i32, P.discipline_flags(policy))
    teps = dt * 1e-3
    stepu = stepi if isinstance(stepi, torch.Tensor) else int(stepi)
    stepuT = stepu[:, None] if (isinstance(stepu, torch.Tensor)
                                and stepu.ndim) else stepu
    seedc = col(seed)

    # Effective per-(thread, step) wake latency under the config's fault
    # row; for no-fault rows the masked dispatch returns `wake_base`
    # bit-identically.
    flt_w1 = counter_uniform(xor_salt(seedc, P.FLT_WAKE_SALT), tidb, stepuT)
    flt_w2 = counter_uniform(xor_salt(seedc, P.FLT_MAG_SALT), tidb, stepuT)
    # M:N environment axis: park_cost re-prices the sleep/wake round trip.
    wake_base = col(wake) * col(park_cost)
    wake_eff = P.fault_wake_delay(col(fault), wake_base, flt_w1, flt_w2,
                                  col(flt_rate), col(flt_scale))
    wake_due = col(now2) + wake_eff
    # Fissile competitive pricing: spin_budget * sws * park_cost on
    # budget_scaled rows, exactly spin_budget elsewhere.
    one_f = torch.ones((), dtype=f32, device=dev)
    budget_eff = lambda sws_now: col(spin_budget) * torch.where(
        col(bscale_f) > 0, col(sws_now).to(f32) * col(park_cost), one_f)

    def first_oh(mask):
        """One-hot of the lowest-tid True per row (all-False rows stay
        all-False)."""
        idx = torch.argmax(mask.to(i32), dim=-1, keepdim=True)
        return (tid == idx) & mask.any(-1, keepdim=True)

    def count(mask):
        return mask.sum(-1).to(i32)

    def rank_of(mask):
        return torch.cumsum(mask.to(i32), dim=-1).to(i32) - 1

    def row_min(v):
        return v.min(dim=-1, keepdim=True).values

    def thc_of(s):
        """Algorithm 1's thc: holder + every waiter, per config."""
        return count(active & (s >= P.CS) & (s <= P.WAKING))

    wl_phase_u, wl_gate_off, wl_tscale = workload_state(
        seedc, tidb, col(now2), col(wl_period), col(wl_duty),
        col(wl_spread))

    def draw_into(mask, lo, hi, c, is_ncs=0):
        u = counter_uniform(seedc, tidb, c)
        val = workload_draw(u, col(lo), col(hi), is_ncs, col(workload),
                            wl_gate_off, wl_tscale, col(wl_burst))
        return val, torch.where(mask, c + 1, c)

    def park(mask, st, wake_at, permits, wake_count, slept, rem):
        """Park, absorbing banked permits (semaphore law — an absorbed
        permit still pays the park/unpark round trip)."""
        grant = mask & (rank_of(mask) < col(permits))
        n_grant = count(grant)
        st = torch.where(grant, P.WAKING, torch.where(mask, P.SLEEP_ST, st))
        wake_at = torch.where(grant, wake_due, wake_at)
        return (st, wake_at, permits - n_grant, wake_count + n_grant,
                torch.where(mask, i1, slept), torch.where(mask, inf, rem))

    def oracle_acquire(happened, winner_oh, thc, sws, cnt, ewma, wuc):
        """A12-A33 at an acquisition: oracle family dispatch, A16-A17
        clamp, C1/C2 correction — windowed disciplines only."""
        do = happened & (win_f > 0)
        spun_w = torch.where(winner_oh, spun, i0).sum(-1).to(i32)
        # budget_scaled rows feed the oracle "did this acquisition park?"
        # alone: every fissile arrival spins first.
        spun_w = spun_w * (1 - bscale_f)
        slept_w = torch.where(winner_oh, slept, i0).sum(-1).to(i32)
        delta, cnt2, ewma2 = map(_i32, P.oracle_update(        # E2-E11
            oracle, spun_w, slept_w, sws, cnt, ewma, k))
        delta = torch.minimum(torch.maximum(delta, 1 - sws),
                              sws_max - sws)                   # A16-A17
        sws2 = sws + delta                                     # A20
        tmp = torch.where((delta < 0) & (thc > sws2), thc - sws2,     # C2
                          torch.where((delta > 0) & (thc > sws), thc - sws,
                                      i0))                            # C1
        corr = torch.sign(delta) * torch.minimum(torch.abs(delta), tmp)
        return (torch.where(do, sws2, sws), torch.where(do, cnt2, cnt),
                torch.where(do, ewma2, ewma),
                torch.where(do, wuc + corr, wuc))

    now_teps = col(now2 + teps)

    # -- open-loop admission: first, so a request admitted at step i is in
    # the system for steps i..j-1 when it departs at step j, and the
    # occupancy integral accumulated at the end of the step equals the
    # recorded latency (j - i) * dt exactly (Little's law).
    open_run = open_state is not None
    if open_run:
        if len(open_state) != len(OPEN_STATE):
            raise ValueError(f"open_state holds the {len(OPEN_STATE)} "
                             f"OPEN_STATE arrays, got {len(open_state)}")
        (req_t, qbuf, hist, qhead, qlen, arrived, shed, departed,
         slo_viol, lat_sum, occ_int) = open_state
        Q = qbuf.shape[1]
        NB = hist.shape[1]
        openc = col(arrival != P.AR_CLOSED)
        ar_phase = counter_uniform(xor_salt(seed, P.AR_PHASE_SALT), 0, 0)
        gate_on = 1.0 - P.workload_off_gate(now2, ar_phase, wl_period,
                                            wl_duty)
        rate = P.arrival_rate_at(arrival, arr_rate, gate_on, wl_burst)
        # Bernoulli-rounded count: floor(rate*dt) plus a trial on the
        # fractional part (closed rows: rate 0, count 0)
        m = rate * dt
        mf = torch.floor(m)
        u_arr = counter_uniform(xor_salt(seed, P.AR_SALT), 0, stepu)
        n_arr = (mf + (u_arr < (m - mf)).to(f32)).to(i32)
        n_adm = torch.minimum(n_arr, q_cap - qlen)   # bounded queue: shed
        qi = torch.arange(Q, dtype=i32, device=dev)[None, :]
        wr = ((qi - col(qhead + qlen)) % Q) < col(n_adm)
        qbuf = torch.where(wr, col(now2), qbuf)
        qlen = qlen + n_adm
        arrived = arrived + n_arr
        shed = shed + (n_arr - n_adm)

    # -- spin-budget exhaustion -> sleep (DES stage order) -----------------
    exhausted = (st == P.SPIN) & (col(budget_f) > 0) & (rem <= REM_EPS)
    st, wake_at, permits, wake_count, slept, rem = park(
        exhausted, st, wake_at, permits, wake_count, slept, rem)

    # -- wake completions --------------------------------------------------
    due = (st == P.WAKING) & (wake_at <= now_teps)
    holder_free = ~(st == P.CS).any(-1, keepdim=True)
    # FIFO rows that park (hapax) grant the oldest ticket, not the lowest
    # tid; for every other row the id pick is unchanged.
    wkey = torch.where(due, ticket, no_ticket)
    winA_f = first_oh(due & (wkey == row_min(wkey)))
    winA = torch.where(col(fifo_f) > 0, winA_f, first_oh(due)) & holder_free
    cs_val, ctr = draw_into(winA, cs_lo, cs_hi, ctr)
    rem = torch.where(winA, cs_val, rem)
    st = torch.where(winA, P.CS, st)
    # a woken thread that finds the lock free acquired "slept and not
    # spun" -> EvalSWS doubles the window
    sws, cnt, ewma, wuc = oracle_acquire(winA.any(-1), winA, thc_of(st),
                                         sws, cnt, ewma, wuc)
    losers = due & ~winA
    to_spin = losers & (col(w2s_f) > 0)    # woken into the spinning window
    st = torch.where(to_spin, P.SPIN, st)
    spun = torch.where(to_spin, i1, spun)
    # fissile re-arms a fresh bounded budget; the mutable row's window
    # spinners keep the unbounded inf sentinel
    rem = torch.where(to_spin,
                      torch.where(col(budget_f) > 0, budget_eff(sws), inf),
                      rem)
    to_park = losers & (col(repark_f) > 0)     # barged: park again
    st, wake_at, permits, wake_count, slept, rem = park(
        to_park, st, wake_at, permits, wake_count, slept, rem)

    # -- CS completion / release ------------------------------------------
    holder_done = (st == P.CS) & (rem <= REM_EPS)
    rel = holder_done.any(-1)
    completed = completed + rel.to(i32)
    completed_pt = completed_pt + holder_done.to(i32)
    thc_pre = thc_of(st)                                   # R14 (pre-FAD)
    do_latch = rel & (win_f > 0)
    r_wuc = torch.where(do_latch & (wuc >= 0), wuc, -i1)   # R2-R6
    wuc = torch.where(do_latch, torch.where(wuc >= 0, i0, wuc + 1), wuc)
    ncs_val, ctr = draw_into(holder_done, ncs_lo, ncs_hi, ctr, is_ncs=1)
    rem = torch.where(holder_done, ncs_val, rem)
    st = torch.where(holder_done, P.NCS, st)               # R9-R10
    # -- open-loop departure: an open config's completed request leaves
    # instead of drawing a fresh NCS; its latency lands in the histogram
    # and the SLO / latency counters, and the slot frees (DONE).  One CS
    # holder per config, so at most one departure per row and step.
    if open_run:
        depart = holder_done & openc
        latv = col(now2) - req_t
        binv = torch.clamp(torch.floor(
            torch.log2(torch.clamp(latv, min=1e-30)
                       / torch.tensor(P.LAT_BIN0, dtype=f32, device=dev))
            * float(P.LAT_BINS_PER_OCTAVE)), 0, NB - 1).to(i32)
        has_dep = depart.any(-1)
        dep_bin = torch.where(depart, binv, i0).sum(-1).to(i32)
        nbi = torch.arange(NB, dtype=i32, device=dev)[None, :]
        hist = hist + ((nbi == dep_bin[:, None])
                       & has_dep[:, None]).to(i32)
        lat_sum = lat_sum + torch.where(depart, latv,
                                        latv.new_zeros(())).sum(-1)
        departed = departed + has_dep.to(i32)
        slo_viol = slo_viol + count(depart & (latv > col(slo)))
        st = torch.where(depart, P.DONE, st)
        rem = torch.where(depart, inf, rem)
        req_t = torch.where(depart, -one_f, req_t)
    # handoff: grant priority is the arrival ticket for FIFO rows, the
    # thread id otherwise — or, with tie_break="random", a fresh seeded
    # per-(thread, step) key (equal random keys fall back to the id)
    spinners = st == P.SPIN
    can_handoff = rel & (hand_f > 0) & spinners.any(-1)
    tb_u = counter_uniform(xor_salt(seedc, P.TB_SALT), tidb, stepuT)
    rkey = (tb_u * float(2 ** 23)).to(i32)
    key = torch.where(spinners,
                      torch.where(col(fifo_f) > 0, ticket,
                                  torch.where(col(tb) > 0, rkey, tidb)),
                      no_ticket)
    cand = spinners & (key == row_min(key))
    winB = first_oh(cand) & col(can_handoff)
    cs_valB, ctr = draw_into(winB, cs_lo, cs_hi, ctr)
    rem = torch.where(winB, cs_valB, rem)
    st = torch.where(winB, P.CS, st)
    sws, cnt, ewma, wuc = oracle_acquire(can_handoff, winB, thc_pre - 1,
                                         sws, cnt, ewma, wuc)
    # wake quota: per-discipline rule (R11-R21 for the mutable row,
    # wake-one for sleep/adaptive, none for pure spin/FIFO)
    n_parked = count((st == P.SLEEP_ST) | (st == P.WAKING))
    quota = _i32(P.discipline_release_quota(policy, r_wuc, thc_pre, sws,
                                            n_parked, can_handoff.to(i32)))
    quota = torch.where(rel, quota, i0)
    sleepers = st == P.SLEEP_ST
    sel_id = sleepers & (rank_of(sleepers) < col(quota))
    # FIFO rows wake the oldest ticket first (their quota is 0/1, so the
    # single min-ticket pick covers it)
    skey = torch.where(sleepers, ticket, no_ticket)
    sel_f = first_oh(sleepers & (skey == row_min(skey))) & (col(quota) > 0)
    sel = torch.where(col(fifo_f) > 0, sel_f, sel_id)
    n_sel = count(sel)
    st = torch.where(sel, P.WAKING, st)
    wake_at = torch.where(sel, wake_due, wake_at)
    wake_count = wake_count + n_sel
    permits = permits + (quota - n_sel)    # park-free permits are banked

    # -- ttas_backoff polls (backoff rows only; exact no-op otherwise) ----
    # The poll IS the acquire path: an eligible spinner (next-poll time
    # reached, lock free) picks the lock up here; every other eligible
    # poller re-arms with a truncated-binary-exponential delay.  Backoff
    # rows never park, so ``wake_at`` doubles as the next-poll time and
    # ``ticket`` as the failed-attempt counter.
    bo_u = counter_uniform(xor_salt(seedc, P.BO_SALT), tidb, stepuT)
    poll = (st == P.SPIN) & (col(backoff_f) > 0) & (wake_at <= now_teps)
    holder_freeP = ~(st == P.CS).any(-1, keepdim=True)
    winP = first_oh(poll) & holder_freeP
    cs_valP, ctr = draw_into(winP, cs_lo, cs_hi, ctr)
    rem = torch.where(winP, cs_valP, rem)
    st = torch.where(winP, P.CS, st)
    poll_fail = poll & ~winP
    ticket = torch.where(poll_fail, ticket + 1, ticket)
    bo_exp = torch.exp2(torch.clamp(ticket, max=P.BO_CAP).to(f32))
    wake_at = torch.where(poll_fail,
                          col(now2) + col(spin_budget) * bo_exp * bo_u,
                          wake_at)

    # -- arrivals (NCS finished) ------------------------------------------
    arr = (st == P.NCS) & (rem <= REM_EPS) & active
    thc_base = thc_of(st)
    rank_a = rank_of(arr)
    thc_pre_i = col(thc_base) + rank_a                     # A4 per arrival
    slept = torch.where(arr, i0, slept)                    # A3
    spun = torch.where(arr, i0, spun)
    holder_free2 = ~(st == P.CS).any(-1, keepdim=True)
    sleeps = arr & (P.discipline_arrival_sleeps(
        col(policy), rank_a, thc_pre_i, col(sws),
        holder_free2.to(i32)) > 0)                         # A7 per row
    nonsleep = arr & ~sleeps
    winC = first_oh(nonsleep) & holder_free2
    cs_valC, ctr = draw_into(winC, cs_lo, cs_hi, ctr)
    rem = torch.where(winC, cs_valC, rem)
    st = torch.where(winC, P.CS, st)
    sws, cnt, ewma, wuc = oracle_acquire(winC.any(-1), winC, thc_base + 1,
                                         sws, cnt, ewma, wuc)
    to_spinC = nonsleep & ~winC
    st = torch.where(to_spinC, P.SPIN, st)
    spun = torch.where(to_spinC, i1, spun)
    rem = torch.where(to_spinC,
                      torch.where(col(budget_f) > 0, budget_eff(sws), inf),
                      rem)
    # ticket-order bookkeeping: every new waiter takes the next ticket
    # (rank order within the step); FIFO rows that park ticket their
    # parking arrivals too
    joiners = to_spinC | (sleeps & (col(fifo_f) > 0))
    ticket = torch.where(joiners, col(nticket) + rank_of(joiners), ticket)
    nticket = nticket + count(joiners)
    # backoff rows: a new spinner starts its attempt counter at 0 and
    # schedules its first re-poll within one base delay
    bo_new = to_spinC & (col(backoff_f) > 0)
    ticket = torch.where(bo_new, i0, ticket)
    wake_at = torch.where(bo_new, col(now2) + col(spin_budget) * bo_u,
                          wake_at)
    st, wake_at, permits, wake_count, slept, rem = park(
        sleeps, st, wake_at, permits, wake_count, slept, rem)
    # retire tickets: spinners keep theirs; FIFO rows that park keep them
    # through SLEEP/WAKING so grants stay in arrival order
    queued = (st == P.SPIN) | ((col(fifo_f) > 0)
                               & ((st == P.SLEEP_ST) | (st == P.WAKING)))
    ticket = torch.where(queued, ticket, no_ticket)

    if not open_run:
        return (st, rem, wake_at, slept, spun, ctr, ticket, completed_pt,
                sws, cnt, ewma, wuc, permits, nticket, completed,
                wake_count)

    # -- open-loop binding: queued requests claim free thread slots (DONE
    # under an open config) in queue order, entering NCS with a workload
    # draw and carrying their arrival time; then the occupancy integral
    # accumulates LAST, so every in-system request is counted for exactly
    # the steps between its admission and its departure.
    freem = active & (st == P.DONE) & openc
    rank_f = rank_of(freem)
    n_bind = torch.minimum(qlen, count(freem))
    bindm = freem & (rank_f < col(n_bind))
    qpos = (col(qhead) + rank_f) % Q
    rt = torch.gather(qbuf, 1, qpos.to(torch.int64))
    ncs_b, ctr = draw_into(bindm, ncs_lo, ncs_hi, ctr, is_ncs=1)
    st = torch.where(bindm, P.NCS, st)
    rem = torch.where(bindm, ncs_b, rem)
    req_t = torch.where(bindm, rt, req_t)
    slept = torch.where(bindm, i0, slept)
    spun = torch.where(bindm, i0, spun)
    qhead = (qhead + n_bind) % Q
    qlen = qlen - n_bind
    busy = count(active & (req_t >= 0.0))
    occ_int = occ_int + (qlen + busy).to(f32) * dt

    return (st, rem, wake_at, slept, spun, ctr, ticket, completed_pt,
            sws, cnt, ewma, wuc, permits, nticket, completed, wake_count,
            req_t, qbuf, hist, qhead, qlen, arrived, shed, departed,
            slo_viol, lat_sum, occ_int)


def lock_sim_block_ref(st, rem, wake_at, slept, spun, ctr, ticket,
                       completed_pt, sws, cnt, ewma, wuc, permits, nticket,
                       completed, wake_count, spin_cpu,
                       step0, alpha, cores, has_budget,
                       policy, threads, dt, wake, cs_lo, cs_hi,
                       ncs_lo, ncs_hi, k, sws_max, spin_budget, seed,
                       oracle, workload, wl_period, wl_duty, wl_burst,
                       wl_spread, arrival, arr_rate, q_cap, slo, tb,
                       fault, flt_rate, flt_scale, park_cost,
                       *, n_sub_steps: int, limit=None, open_state=None):
    """``n_sub_steps`` fused timesteps for a (C, T) block of configurations.

    Each sub-step is one per-step iteration of the rollout —
    :func:`lock_sim_step_ref` (GPS advance), :func:`fault_rewind`, then
    :func:`lock_transitions_ref` — with ``now2 = (step0 + s + 1) * dt``
    computed from the int32 global step index before the float multiply,
    and ``spin_cpu`` accumulated inside the loop, so the blocked rollout
    is bit-identical to the per-step path.

    State is the 16 transition arrays plus ``spin_cpu`` (C,) f32; ``step0``
    is the global index of the first sub-step (int or (C,) int32).
    ``limit`` (int or (C,) int32) caps the global step index: sub-steps
    with ``step0 + s >= limit`` select the pre-step state unchanged, so a
    partial tail block equals running exactly that many steps.  Returns the
    17 updated state arrays — plus the 11 :data:`OPEN_STATE` arrays,
    carried through the loop and masked by ``limit`` like the closed
    state (the 2-d ``(C, Q)`` / ``(C, NB)`` ones included), when
    ``open_state`` is given.  Inputs are not modified."""
    n_open = 0 if open_state is None else len(open_state)
    if open_state is not None and n_open != len(OPEN_STATE):
        raise ValueError(f"open_state holds the {len(OPEN_STATE)} "
                         f"OPEN_STATE arrays, got {n_open}")
    dev = st.device
    state = (st, rem, wake_at, slept, spun, ctr, ticket, completed_pt,
             sws, cnt, ewma, wuc, permits, nticket, completed, wake_count,
             *(open_state or ()))
    cpu = spin_cpu
    as_i32 = lambda v: (v if isinstance(v, torch.Tensor)
                        else torch.tensor(int(v), dtype=torch.int32,
                                          device=dev))
    step0 = as_i32(step0)
    if limit is not None:
        limit = as_i32(limit)
    for s in range(int(n_sub_steps)):
        i = step0 + s
        i_f = i.to(torch.float32)
        now2 = (i_f + 1.0) * dt
        st_s = state[0]
        rem_s, burn = lock_sim_step_ref(st_s, state[1], alpha, cores, dt,
                                        has_budget)
        rem_s = fault_rewind(st_s, rem_s, alpha, cores, dt, i_f * dt, seed,
                             fault, flt_rate, flt_scale)
        new = lock_transitions_ref(st_s, rem_s, *state[2:16], now2, i,
                                   policy, threads, dt, wake, cs_lo,
                                   cs_hi, ncs_lo, ncs_hi, k, sws_max,
                                   spin_budget, seed, oracle, workload,
                                   wl_period, wl_duty, wl_burst,
                                   wl_spread, arrival, arr_rate, q_cap,
                                   slo, tb, fault, flt_rate, flt_scale,
                                   park_cost,
                                   open_state=state[16:] if n_open else None)
        if limit is None:
            state, cpu = new, cpu + burn
            continue
        act = i < limit                       # bool scalar or (C,)
        actT = act[..., None] if act.ndim else act
        state = tuple(torch.where(actT if n.ndim == 2 else act, n, o)
                      for n, o in zip(new, state))
        cpu = cpu + torch.where(act, burn, burn.new_zeros(()))
    return (*state[:16], cpu, *state[16:])


def oracle_update_ref(oracle_id, spun, slept, sws, cnt, ewma, k, sws_max):
    """Batched SWS-oracle observation over ``(C,)`` config vectors: one
    observation of every oracle family row dispatched by ``oracle_id``,
    with the A16-A17 clamp applied.  All inputs int32 except
    ``spun``/``slept`` (bool or 0/1 int32).  Returns
    ``(delta, cnt', ewma')`` int32 with ``1 <= sws + delta <= sws_max``."""
    delta, cnt1, ewma1 = map(_i32, P.oracle_update(oracle_id, spun, slept,
                                                   sws, cnt, ewma, k))
    delta = torch.minimum(torch.maximum(delta, 1 - sws), sws_max - sws)
    return delta, cnt1, ewma1


# --------------------------------------------------------------------------
# The language model's kernels (repro/kernels/ref.py: flash_attention_ref,
# rmsnorm_ref): direct dense math in f32, the plain versions of
# kernels/flash_attention.py and kernels/rmsnorm.py
# --------------------------------------------------------------------------
def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (BH, Sq, hd); k, v: (BKV, Sk, hd), query head b reading kv head
    ``b // (BH // BKV)``.  Returns (BH, Sq, hd) in q's dtype."""
    BH, Sq, hd = q.shape
    BKV, Sk, _ = k.shape
    g = BH // BKV
    k = torch.repeat_interleave(k, g, dim=0)
    v = torch.repeat_interleave(v, g, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qp = torch.arange(Sq, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= qp >= kp
    if window:
        m &= (qp - kp) < window
    s = torch.where(m, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def rmsnorm_ref(x, w, eps: float = 1e-6):
    """``x * rsqrt(mean(x^2) + eps) * (1 + w)`` over the last dim, in f32,
    returned in x's dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)
