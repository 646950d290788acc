"""The plain reference of the lock simulator: one config row at a time, in
NumPy float32, with nothing of the program imported.

It follows the published semantics of the batched fixed-timestep
simulator (generalised processor sharing on a fixed ``dt``, then one
transition stage a step: [open-loop admission] -> spin-budget exhaustion
-> wake completions -> CS release / hand-off [+ departure] -> back-off
polls -> arrivals -> ticket retire [-> binding + occupancy]) and gives,
for a row run ``n_steps`` steps, the per-config summary a sweep returns:
completed CS, spin CPU, wake-ups, final window, ``t_end``, the fairness
spread and, open loop, the request counters and the latency histogram.

Every float is float32 and every operation is written in the order the
semantics fix, so a run is bit-exact; integer state is Python ints.
Rows are independent, so the reference runs row by row and skips the
steps in which nothing but residual work and the running sums move:
those are replayed exactly by ``np.subtract.accumulate`` /
``np.add.accumulate`` (sequential float32), and a step in which any
thread crosses a threshold, a wake-up or poll falls due or a request
arrives is run in full.

What it covers: every discipline row (spin, sleep, adaptive, mutable,
fifo, fissile, hapax, ttas_backoff), every oracle family, the closed
loop and the poisson and bursty open loops, both tie-breaks.  It refuses
the workload rows other than ``constant`` and any fault row other than
``none``, which no cell of this benchmark uses.

``precision="bfloat16"`` rounds every float the row carries or derives
to bfloat16 after each operation, one step at a time: the benchmark's
control, the reference in the next precision below the configuration's
float32.
"""

from __future__ import annotations

import math

import numpy as np

F = np.float32
F0, F1 = F(0.0), F(1.0)
EPS = F(1e-9)
INF = F(np.inf)
TWO_M32 = F(2.0 ** -32)
M32 = 0xFFFFFFFF
NO_TICKET = 2 ** 31 - 1

NCS, CS, SPIN, SLEEP, WAKING, DONE = range(6)
TAS, TTAS, MCS, SLEEP_LOCK, ADAPTIVE, MUTABLE, FIFO, FISSILE, HAPAX, \
    TTAS_BACKOFF = range(10)
AR_CLOSED, AR_POISSON, AR_BURSTY = range(3)

WL_PHASE_SALT = 0x7F4A7C15
AR_SALT = 0x94D049BB
AR_PHASE_SALT = 0xBF58476D
TB_SALT = 0xD6E8FEB8
BO_SALT = 0x165667B1
BO_CAP = 6
EWMA_ONE, EWMA_SHIFT = 256, 3
QUEUE_MAX = 128
LAT_NBINS = 64
LAT_BIN0 = F(1e-7)
LAT_BINS_PER_OCTAVE = F(2.0)

#: (handoff, fifo_grant, budget_spin, wake_to_spin, repark, windowed,
#:  budget_scaled, backoff, arrival rule, quota rule) per policy id.
_ROWS = {
    TAS: (1, 0, 0, 0, 0, 0, 0, 0, "never", "zero"),
    TTAS: (1, 0, 0, 0, 0, 0, 0, 0, "never", "zero"),
    MCS: (1, 0, 0, 0, 0, 0, 0, 0, "never", "zero"),
    SLEEP_LOCK: (0, 0, 0, 0, 1, 0, 0, 0, "sleep", "one"),
    ADAPTIVE: (1, 0, 1, 0, 1, 0, 0, 0, "never", "one_no_handoff"),
    MUTABLE: (1, 0, 0, 1, 0, 1, 0, 0, "window", "mutable"),
    FIFO: (1, 1, 0, 0, 0, 0, 0, 0, "never", "zero"),
    FISSILE: (1, 0, 1, 1, 0, 1, 1, 0, "never", "one_no_handoff"),
    HAPAX: (0, 1, 0, 0, 0, 0, 0, 0, "fifo_park", "one"),
    TTAS_BACKOFF: (0, 0, 0, 0, 0, 0, 0, 1, "never", "zero"),
}

#: Per-row columns the reference reads (the encoded float32 / int form).
ROW_FIELDS = ("policy", "threads", "cores", "cs_lo", "cs_hi", "ncs_lo",
              "ncs_hi", "wake", "alpha", "sws_init", "sws_max", "k",
              "spin_budget", "seed", "oracle", "workload", "wl_period",
              "wl_duty", "wl_burst", "arrival_phase", "arrival",
              "arr_rate", "q_cap", "slo", "tb", "fault", "park_cost", "dt")


def _bf16(x):
    """Round float32 values to the nearest bfloat16 (ties to even), kept
    in float32 storage."""
    if np.ndim(x) == 0:
        b = int(F(x).view(np.uint32))
        if b & 0x7F800000 == 0x7F800000:
            return F(x)
        b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
        return np.uint32(b & M32).view(np.float32)
    a = np.asarray(x, np.float32)
    b = a.view(np.uint32).astype(np.uint64)
    b = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16
    out = (b & M32).astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(a), out, a)


def uniform(seed: int, tid: int, ctr: int) -> np.float32:
    """The counter-based uniform in [0, 1) of (config seed, thread, event
    counter): a splitmix-style avalanche on 32-bit words, the word
    converted to float32 and scaled by 2^-32."""
    x = (seed ^ ((tid * 0x9E3779B9) & M32)
         ^ ((((ctr + 1) & M32) * 0x85EBCA6B) & M32))
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    x ^= x >> 16
    return F(x) * TWO_M32


def uniform_steps(seed: int, tid: int, steps: np.ndarray) -> np.ndarray:
    """:func:`uniform` over an array of counters (uint64 arithmetic)."""
    m = np.uint64(M32)
    c = steps.astype(np.uint64)
    x = (np.uint64(seed) ^ np.uint64((tid * 0x9E3779B9) & M32)
         ^ ((((c + np.uint64(1)) & m) * np.uint64(0x85EBCA6B)) & m))
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & m
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & m
    x ^= x >> np.uint64(16)
    return x.astype(np.float32) * TWO_M32


def latency_bin(latv: np.float32):
    """The histogram bin of a latency, ``floor(2 log2(lat / 1e-7))``
    clipped to the 64 bins, as ``(low, high)``.  The float32 ``log2`` of
    a device library may differ from the exact one by an ulp or two, so
    where the exact value lies within 1e-4 of a bin edge either neighbour
    is right: ``low < high`` then names both."""
    q = F(max(latv, F(1e-30)) / LAT_BIN0)
    t = math.log2(float(q)) * float(LAT_BINS_PER_OCTAVE)
    lo = min(max(math.floor(t - 1e-4), 0), LAT_NBINS - 1)
    hi = min(max(math.floor(t + 1e-4), 0), LAT_NBINS - 1)
    return lo, hi


class RowSim:
    """One config row of the simulator, run step by step from its
    initial state (see the module docstring)."""

    def __init__(self, row: dict, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.q = _bf16 if precision == "bfloat16" else (lambda x: x)
        self.skip = precision == "float32"
        if int(row["workload"]) != 0:
            raise NotImplementedError("only the constant workload row")
        if int(row["fault"]) != 0:
            raise NotImplementedError("only the fault row 'none'")
        q = self.q
        g = lambda k: q(F(row[k]))
        self.policy = int(row["policy"])
        (self.hand_f, self.fifo_f, self.budget_f, self.w2s_f, self.repark_f,
         self.win_f, self.bscale_f, self.backoff_f, self.arrive_rule,
         self.quota_rule) = _ROWS[self.policy]
        T = self.T = int(row["threads"])
        self.cores, self.alpha, self.dt = g("cores"), g("alpha"), g("dt")
        self.cs_lo, self.cs_hi = g("cs_lo"), g("cs_hi")
        self.ncs_lo, self.ncs_hi = g("ncs_lo"), g("ncs_hi")
        self.spin_budget, self.park_cost = g("spin_budget"), g("park_cost")
        self.wl_period, self.wl_duty = g("wl_period"), g("wl_duty")
        self.wl_burst, self.arr_rate, self.slo = (g("wl_burst"),
                                                  g("arr_rate"), g("slo"))
        self.seed = int(row["seed"]) & M32
        self.oracle, self.k = int(row["oracle"]), int(row["k"])
        self.sws_max = int(row["sws_max"])
        self.tb, self.q_cap = int(row["tb"]), int(row["q_cap"])
        self.arrival = int(row["arrival"])
        self.open = self.arrival != AR_CLOSED
        self.teps = q(F(self.dt * F(1e-3)))
        self.wake_base = q(F(g("wake") * self.park_cost))
        self.tid = np.arange(T)

        # initial state: every thread of a closed row in NCS with a fresh
        # draw plus the arrival-order stagger; an open row's threads idle
        self.ctr = [1] * T
        phase = g("arrival_phase")
        mean_ncs = q(F(F(0.5) * q(F(self.ncs_lo + self.ncs_hi))))
        rem0 = np.empty(T, np.float32)
        for t in range(T):
            base = self._draw(t, 0, self.ncs_lo, self.ncs_hi)
            ph = uniform(self.seed ^ WL_PHASE_SALT, t, 0)
            rem0[t] = q(F(base + q(F(q(F(ph * phase)) * mean_ncs))))
        if self.open:
            self.st = np.full(T, DONE, np.int64)
            self.rem = np.full(T, INF, np.float32)
        else:
            self.st = np.full(T, NCS, np.int64)
            self.rem = rem0
        self.wake_at = np.full(T, INF, np.float32)
        self.slept = np.zeros(T, np.int64)
        self.spun = np.zeros(T, np.int64)
        self.ticket = np.full(T, NO_TICKET, np.int64)
        self.cpt = np.zeros(T, np.int64)
        self.sws = int(row["sws_init"])
        self.cnt = self.ewma = self.wuc = self.permits = 0
        self.nticket = self.completed = self.wake_count = 0
        self.spin_cpu = F0
        # open-loop state
        self.req_t = np.full(T, F(-1.0), np.float32)
        self.qbuf = np.zeros(QUEUE_MAX, np.float32)
        self.hist = np.zeros(LAT_NBINS, np.int64)
        self.amb = np.zeros(LAT_NBINS + 1, np.int64)
        self.qhead = self.qlen = 0
        self.arrived = self.shed = self.departed = self.slo_viol = 0
        self.lat_sum = self.occ_int = F0
        self.ar_phase = uniform(self.seed ^ AR_PHASE_SALT, 0, 0)
        #: block index (of ``block_steps``) at which ``completed`` first
        #: reached the target, or None
        self.converged_block = None

    # -- helpers -----------------------------------------------------------
    def _draw(self, t: int, ctr: int, lo, hi):
        """A constant-workload hold time ``lo + u (hi - lo)``."""
        q = self.q
        u = uniform(self.seed, t, ctr)
        return q(F(lo + q(F(u * q(F(hi - lo))))))

    def _draw_into(self, mask, lo, hi):
        """Fresh hold times for the threads of ``mask`` (their counters
        advance); returns {thread: value}."""
        out = {}
        for t in np.flatnonzero(mask):
            t = int(t)
            out[t] = self._draw(t, self.ctr[t], lo, hi)
            self.ctr[t] = (self.ctr[t] + 1) & M32
        return out

    def _now2(self, i: int):
        return self.q(F(self.q(F(F(i) + F1)) * self.dt))

    def _thc(self):
        st = self.st
        return int(np.count_nonzero((st >= CS) & (st <= WAKING)))

    @staticmethod
    def _first(mask):
        idx = np.flatnonzero(mask)
        out = np.zeros(mask.shape, bool)
        if idx.size:
            out[idx[0]] = True
        return out

    @staticmethod
    def _rank(mask):
        return np.cumsum(mask) - 1

    def _budget_eff(self):
        if self.bscale_f:
            return self.q(F(self.spin_budget
                            * self.q(F(F(self.sws) * self.park_cost))))
        return self.q(F(self.spin_budget * F1))

    def _park(self, mask, wake_due):
        if not mask.any():
            return
        grant = mask & (self._rank(mask) < self.permits)
        n_grant = int(np.count_nonzero(grant))
        self.st = np.where(grant, WAKING, np.where(mask, SLEEP, self.st))
        self.wake_at = np.where(grant, wake_due, self.wake_at) \
            .astype(np.float32)
        self.permits -= n_grant
        self.wake_count += n_grant
        self.slept = np.where(mask, 1, self.slept)
        self.rem = np.where(mask, INF, self.rem).astype(np.float32)

    def _oracle(self, winner, thc: int):
        """An acquisition by ``winner``: the oracle observation, the
        window clamp and the C1 / C2 correction (windowed rows only)."""
        if not self.win_f:
            return
        t = int(np.flatnonzero(winner)[0])
        spun_w = int(self.spun[t]) * (1 - self.bscale_f)
        slept_w = int(self.slept[t])
        sws, cnt, ewma, k = self.sws, self.cnt, self.ewma, self.k
        late = slept_w * (1 - spun_w)
        o = self.oracle
        if o in (0, 1):
            cnt1 = cnt + 1
            hitk = (cnt1 >= k) * (1 - late)
            delta = late * sws - hitk if o == 0 \
                else late - hitk * (sws // 2)
            cnt1 = (1 - late) * (1 - hitk) * cnt1
            ewma1 = ewma
        elif o == 2:
            delta, cnt1, ewma1 = k - sws, 0, ewma
        else:
            ewma1 = ewma + ((late * EWMA_ONE - ewma) >> EWMA_SHIFT)
            target = EWMA_ONE // (k + 1)
            grow = int(ewma1 > 2 * target)
            shrink = int(2 * ewma1 < target) * (1 - grow)
            delta, cnt1 = grow * sws - shrink, 0
        delta = min(max(delta, 1 - sws), self.sws_max - sws)
        sws2 = sws + delta
        if delta < 0 and thc > sws2:
            tmp = thc - sws2
        elif delta > 0 and thc > sws:
            tmp = thc - sws
        else:
            tmp = 0
        corr = (delta > 0) - (delta < 0)
        self.sws, self.cnt, self.ewma = sws2, cnt1, ewma1
        self.wuc += corr * min(abs(delta), tmp)

    def _arrival_sleeps(self, rank, thc_pre, holder_free: int):
        r = self.arrive_rule
        if r == "never":
            return np.zeros(rank.shape, bool)
        if r == "sleep":
            return ~((rank == 0) & bool(holder_free))
        if r == "window":
            return thc_pre >= self.sws
        return ~((thc_pre == 0) & bool(holder_free))          # fifo_park

    def _quota(self, r_wuc, thc_pre, n_parked, handoff_taken):
        r = self.quota_rule
        if r == "zero":
            return 0
        if r == "one":
            return int(n_parked > 0)
        if r == "one_no_handoff":
            return int(n_parked > 0) * (1 - handoff_taken)
        return int(r_wuc >= 0) * (r_wuc + int(thc_pre > self.sws))

    def _arrivals_at(self, steps: np.ndarray):
        """Requests offered at each global step of ``steps`` (open rows):
        ``floor(rate dt)`` plus a Bernoulli trial on the fraction."""
        q, dt = self.q, self.dt
        if self.arrival == AR_BURSTY:
            now2 = (((steps.astype(np.float32) + F1) * dt)
                    .astype(np.float32))
            pos = np.remainder(
                (now2 / self.wl_period).astype(np.float32) + self.ar_phase,
                F1).astype(np.float32)
            gate_on = F1 - (pos >= self.wl_duty).astype(np.float32)
            rate = (self.arr_rate * (F1 + gate_on * q(F(self.wl_burst - F1)))
                    .astype(np.float32)).astype(np.float32)
        else:
            rate = np.full(steps.shape, self.arr_rate, np.float32)
        m = (rate * dt).astype(np.float32)
        mf = np.floor(m)
        u = uniform_steps(self.seed ^ AR_SALT, 0, steps)
        return (mf + (u < (m - mf)).astype(np.float32)).astype(np.int64)

    # -- one step ----------------------------------------------------------
    def _rates(self):
        """The GPS advance of the current states: per-thread decrement of
        the residual work and the step's spin burn."""
        q, dt, st = self.q, self.dt, self.st
        is_cs, is_ncs, is_spin = st == CS, st == NCS, st == SPIN
        n_run = F(np.count_nonzero(is_cs | is_ncs | is_spin))
        n_spin = F(np.count_nonzero(is_spin))
        rate = min(q(F(self.cores / max(n_run, F1))), F1)
        holder_rate = q(F(rate / q(F(F1 + q(F(self.alpha * n_spin))))))
        d_rate = q(F(dt * rate))
        dec = np.zeros(self.T, np.float32)
        dec[is_cs] = q(F(dt * holder_rate))
        dec[is_ncs] = d_rate
        if self.budget_f:
            dec[is_spin] = d_rate
        return dec, q(F(n_spin * d_rate))

    def _step(self, i: int, dec, burn):
        """Step ``i`` in full: the advance, then the transition stage."""
        q = self.q
        self.rem = q((self.rem - dec).astype(np.float32))
        self.spin_cpu = q(F(self.spin_cpu + burn))
        now2 = self._now2(i)
        now_teps = q(F(now2 + self.teps))
        wake_due = q(F(now2 + self.wake_base))

        if self.open:                                   # admission
            n_arr = int(self._arrivals_at(np.asarray([i]))[0])
            n_adm = min(n_arr, self.q_cap - self.qlen)
            for j in range(n_adm):
                self.qbuf[(self.qhead + self.qlen + j) % QUEUE_MAX] = now2
            self.qlen += n_adm
            self.arrived += n_arr
            self.shed += n_arr - n_adm

        st, rem = self.st, self.rem
        if self.budget_f:                               # budget exhaustion
            self._park((st == SPIN) & (rem <= EPS), wake_due)

        due = (self.st == WAKING) & (self.wake_at <= now_teps)
        if due.any():                                   # wake completions
            holder_free = not (self.st == CS).any()
            if self.fifo_f:
                wkey = np.where(due, self.ticket, NO_TICKET)
                winA = self._first(due & (wkey == wkey.min()))
            else:
                winA = self._first(due)
            if not holder_free:
                winA[:] = False
            for t, v in self._draw_into(winA, self.cs_lo,
                                        self.cs_hi).items():
                self.rem[t] = v
                self.st[t] = CS
            if winA.any():
                self._oracle(winA, self._thc())
            losers = due & ~winA
            if self.w2s_f:
                self.st = np.where(losers, SPIN, self.st)
                self.spun = np.where(losers, 1, self.spun)
                self.rem = np.where(
                    losers, self._budget_eff() if self.budget_f else INF,
                    self.rem).astype(np.float32)
            if self.repark_f:
                self._park(losers, wake_due)

        holder_done = (self.st == CS) & (self.rem <= EPS)
        rel = bool(holder_done.any())
        r_wuc, thc_pre = -1, 0
        if rel:                                         # release
            self.completed += 1
            self.cpt += holder_done
            thc_pre = self._thc()
            if self.win_f:
                r_wuc = self.wuc if self.wuc >= 0 else -1
                self.wuc = 0 if self.wuc >= 0 else self.wuc + 1
            for t, v in self._draw_into(holder_done, self.ncs_lo,
                                        self.ncs_hi).items():
                self.rem[t] = v
                self.st[t] = NCS
                if self.open:                           # departure
                    latv = q(F(now2 - self.req_t[t]))
                    lo, hi = latency_bin(latv)
                    self.hist[lo] += 1
                    if hi != lo:
                        self.amb[hi] += 1
                    self.lat_sum = q(F(self.lat_sum + latv))
                    self.departed += 1
                    self.slo_viol += int(latv > self.slo)
                    self.st[t] = DONE
                    self.rem[t] = INF
                    self.req_t[t] = F(-1.0)
            spinners = self.st == SPIN
            can_handoff = int(bool(self.hand_f) and bool(spinners.any()))
            if can_handoff:                             # hand-off
                if self.fifo_f:
                    key = self.ticket
                elif self.tb:
                    tb_u = np.asarray([uniform(self.seed ^ TB_SALT, t, i)
                                       for t in range(self.T)], np.float32)
                    key = (tb_u * F(2.0 ** 23)).astype(np.int64)
                else:
                    key = self.tid
                key = np.where(spinners, key, NO_TICKET)
                winB = self._first(spinners & (key == key.min()))
                for t, v in self._draw_into(winB, self.cs_lo,
                                            self.cs_hi).items():
                    self.rem[t] = v
                    self.st[t] = CS
                self._oracle(winB, thc_pre - 1)
            n_parked = int(np.count_nonzero((self.st == SLEEP)
                                            | (self.st == WAKING)))
            quota = self._quota(r_wuc, thc_pre, n_parked, can_handoff)
            sleepers = self.st == SLEEP
            if self.fifo_f:
                skey = np.where(sleepers, self.ticket, NO_TICKET)
                sel = self._first(sleepers & (skey == skey.min())) \
                    & (quota > 0)
            else:
                sel = sleepers & (self._rank(sleepers) < quota)
            n_sel = int(np.count_nonzero(sel))
            self.st = np.where(sel, WAKING, self.st)
            self.wake_at = np.where(sel, wake_due, self.wake_at) \
                .astype(np.float32)
            self.wake_count += n_sel
            self.permits += quota - n_sel

        if self.backoff_f:                              # back-off polls
            poll = (self.st == SPIN) & (self.wake_at <= now_teps)
            if poll.any():
                bo_u = np.asarray([uniform(self.seed ^ BO_SALT, t, i)
                                   for t in range(self.T)], np.float32)
                winP = self._first(poll) if not (self.st == CS).any() \
                    else np.zeros(self.T, bool)
                for t, v in self._draw_into(winP, self.cs_lo,
                                            self.cs_hi).items():
                    self.rem[t] = v
                    self.st[t] = CS
                fail = poll & ~winP
                self.ticket = np.where(fail, self.ticket + 1, self.ticket)
                bo_exp = np.ldexp(F1, np.minimum(self.ticket, BO_CAP)) \
                    .astype(np.float32)
                delay = q((q((self.spin_budget * bo_exp)
                              .astype(np.float32)) * bo_u)
                          .astype(np.float32))
                self.wake_at = np.where(
                    fail, q((now2 + delay).astype(np.float32)),
                    self.wake_at).astype(np.float32)

        arr = (self.st == NCS) & (self.rem <= EPS)
        if arr.any():                                   # arrivals
            thc_base = self._thc()
            rank_a = self._rank(arr)
            self.slept = np.where(arr, 0, self.slept)
            self.spun = np.where(arr, 0, self.spun)
            holder_free2 = int(not (self.st == CS).any())
            sleeps = arr & self._arrival_sleeps(rank_a, thc_base + rank_a,
                                                holder_free2)
            nonsleep = arr & ~sleeps
            winC = self._first(nonsleep) if holder_free2 \
                else np.zeros(self.T, bool)
            for t, v in self._draw_into(winC, self.cs_lo,
                                        self.cs_hi).items():
                self.rem[t] = v
                self.st[t] = CS
            if winC.any():
                self._oracle(winC, thc_base + 1)
            to_spin = nonsleep & ~winC
            self.st = np.where(to_spin, SPIN, self.st)
            self.spun = np.where(to_spin, 1, self.spun)
            self.rem = np.where(
                to_spin, self._budget_eff() if self.budget_f else INF,
                self.rem).astype(np.float32)
            joiners = to_spin | (sleeps & bool(self.fifo_f))
            self.ticket = np.where(joiners,
                                   self.nticket + self._rank(joiners),
                                   self.ticket)
            self.nticket += int(np.count_nonzero(joiners))
            if self.backoff_f and to_spin.any():
                bo_u = np.asarray([uniform(self.seed ^ BO_SALT, t, i)
                                   for t in range(self.T)], np.float32)
                self.ticket = np.where(to_spin, 0, self.ticket)
                first = q((now2 + q((self.spin_budget * bo_u)
                                    .astype(np.float32)))
                          .astype(np.float32))
                self.wake_at = np.where(to_spin, first, self.wake_at) \
                    .astype(np.float32)
            self._park(sleeps, wake_due)

        st = self.st
        queued = (st == SPIN) | (bool(self.fifo_f)
                                 & ((st == SLEEP) | (st == WAKING)))
        self.ticket = np.where(queued, self.ticket, NO_TICKET)

        if self.open:                                   # binding
            freem = self.st == DONE
            n_bind = min(self.qlen, int(np.count_nonzero(freem)))
            if n_bind:
                rank_f = self._rank(freem)
                bindm = freem & (rank_f < n_bind)
                for t, v in self._draw_into(bindm, self.ncs_lo,
                                            self.ncs_hi).items():
                    self.st[t] = NCS
                    self.rem[t] = v
                    self.req_t[t] = self.qbuf[(self.qhead + int(rank_f[t]))
                                              % QUEUE_MAX]
                    self.slept[t] = 0
                    self.spun[t] = 0
                self.qhead = (self.qhead + n_bind) % QUEUE_MAX
                self.qlen -= n_bind
            self.occ_int = q(F(self.occ_int + self._occ_add()))

    def _occ_add(self):
        busy = int(np.count_nonzero(self.req_t >= F0))
        return self.q(F(F(self.qlen + busy) * self.dt))

    # -- steps in which nothing happens -------------------------------------
    def _next_event(self, i: int, W: int, dec):
        """The offset in ``[0, W)`` of the first step from ``i`` in which
        the transition stage can change anything, or None; with the
        residual-work trajectory of the decrementing threads."""
        moving = np.flatnonzero(dec > F0)
        traj = None
        best = W
        if moving.size:
            A = np.empty((W + 1, moving.size), np.float32)
            A[0] = self.rem[moving]
            A[1:] = dec[moving]
            traj = self.q(np.subtract.accumulate(A, axis=0))
            hit = np.flatnonzero((traj[1:] <= EPS).any(axis=1))
            if hit.size:
                best = int(hit[0])
        st = self.st
        watch = st == WAKING
        if self.backoff_f:
            watch |= st == SPIN
        if watch.any():
            first_due = self.wake_at[watch].min()
            steps = np.arange(i, i + best, dtype=np.int64)
            now2 = ((steps.astype(np.float32) + F1) * self.dt) \
                .astype(np.float32)
            hit = np.flatnonzero((now2 + self.teps).astype(np.float32)
                                 >= first_due)
            if hit.size:
                best = min(best, int(hit[0]))
        if self.open:
            if self.qlen and (st == DONE).any():
                best = 0
            elif best:
                n = self._arrivals_at(np.arange(i, i + best,
                                                dtype=np.int64))
                hit = np.flatnonzero(n > 0)
                if hit.size:
                    best = min(best, int(hit[0]))
        return (None if best >= W else best), moving, traj

    def _quiet(self, n: int, moving, traj, burn):
        """Replay ``n`` steps in which only residual work and the running
        sums move."""
        if traj is not None:
            self.rem[moving] = traj[n]
        if burn != F0:
            self.spin_cpu = self.q(np.add.accumulate(
                np.concatenate([[self.spin_cpu], np.full(n, burn, F)])
                .astype(np.float32))[-1])
        if self.open:
            add = self._occ_add()
            if add != F0:
                self.occ_int = self.q(np.add.accumulate(
                    np.concatenate([[self.occ_int], np.full(n, add, F)])
                    .astype(np.float32))[-1])

    def run(self, n_steps: int, target_cs: int = 0,
            block_steps: int = 32) -> "RowSim":
        """Run steps ``0 .. n_steps - 1``; note the block at whose end
        ``completed`` first reached ``target_cs``.  In float32 quiet
        stretches are replayed in windows of up to 2^15 steps; in
        bfloat16 one step at a time (each rounds)."""
        i, W = 0, 64
        while i < n_steps:
            dec, burn = self._rates()
            W = min(W, n_steps - i) if self.skip else 1
            off, moving, traj = self._next_event(i, W, dec)
            if off is None:
                before = (self.rem.copy(), self.spin_cpu, self.occ_int)
                self._quiet(W, moving, traj, burn)
                i += W
                self._note_block(i, target_cs, block_steps)
                W = min(4 * W, 1 << 15)
                if not self.skip and self._fixed(*before):
                    # bfloat16 rounding has frozen every running sum: the
                    # quiet steps to the next due time repeat this one
                    W2 = min(1 << 15, n_steps - i)
                    if W2:
                        off2, _, _ = self._next_event(i, W2, dec * F0)
                        i += W2 if off2 is None else off2
                        self._note_block(i, target_cs, block_steps)
                continue
            if off:
                self._quiet(off, moving, traj, burn)
                i += off
                self._note_block(i, target_cs, block_steps)
            W = 64
            self._step(i, dec, burn)
            i += 1
            self._note_block(i, target_cs, block_steps)
        self.steps = n_steps
        return self

    def _fixed(self, rem, spin_cpu, occ_int) -> bool:
        return (np.array_equal(self.rem, rem) and self.spin_cpu == spin_cpu
                and self.occ_int == occ_int)

    def _note_block(self, i: int, target_cs: int, block_steps: int):
        if (self.converged_block is None and target_cs
                and self.completed >= target_cs):
            self.converged_block = -(-i // block_steps)

    def summary(self) -> dict:
        """The per-config summary of a sweep, after :meth:`run`."""
        ex = self.steps
        out = {"completed": self.completed,
               "spin_cpu": float(self.spin_cpu),
               "wake_count": self.wake_count,
               "final_sws": self.sws,
               "t_end": float(self.q(F(F(ex) * self.dt))),
               "steps_run": ex,
               "fairness": int(self.cpt.max() - self.cpt.min())}
        if self.open:
            busy = int(np.count_nonzero(self.req_t >= F0))
            out.update(arrived=self.arrived, shed=self.shed,
                       departed=self.departed, slo_viol=self.slo_viol,
                       lat_sum=float(self.lat_sum),
                       occ_int=float(self.occ_int),
                       in_flight=self.qlen + busy,
                       lat_hist=self.hist.tolist(),
                       lat_ambiguous=self.amb.tolist())
        return out


def simulate_row(row: dict, n_steps: int, target_cs: int = 0,
                 precision: str = "float32") -> dict:
    """Run one encoded row (:data:`ROW_FIELDS`) for ``n_steps`` steps;
    returns :meth:`RowSim.summary` with ``converged_block``."""
    sim = RowSim(row, precision).run(int(n_steps), int(target_cs))
    out = sim.summary()
    out["converged_block"] = sim.converged_block
    return out
