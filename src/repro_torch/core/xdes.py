"""xdes — batched, fixed-timestep simulation of lock disciplines on PyTorch.

The port of ``repro/core/xdes.py``: thousands of
:class:`repro_torch.core.policy.SimConfig` rows simulated in one device
program, a generalized-processor-sharing step on a fixed timestep, closed
loop or with open-loop arrivals (a config whose ``arrival`` row is not
``closed`` draws requests into a bounded queue, binds them to free thread
slots and records each request's latency in an on-device histogram).

The rollout is **time-blocked** (``rollout="blocked"``, the default): a
host loop whose body is ONE kernel launch per ``block_steps`` timesteps
(:func:`repro_torch.kernels.lock_sim.lock_sim_block` — the hand-written
CUDA kernel for CUDA tensors, its plain version for CPU tensors, or the
plain version everywhere with ``backend="ref"``).  After every block the
loop reads one count back — ``(completed >= target_cs).sum()`` — and
**exits early** when every config has converged, exactly at the block
boundaries where the reference's ``while_loop`` does, so ``steps_run`` and
``t_end`` agree.  ``rollout="scan"`` is the per-step path: the GPS advance
(:func:`~repro_torch.kernels.lock_sim.lock_sim_step`), the fault rewind
(plain PyTorch, as in the reference) and one transition stage
(:func:`~repro_torch.kernels.lock_sim.lock_transitions_step`) per step, two
kernel launches per step on the card, no early exit: the parity reference
the blocked path is pinned bit-identical against.

Entry points run on the card: ``device=None`` resolves to CUDA and raises
when there is none.  Pass ``device="cpu"`` to run the plain versions on the
host, as the tests do.

The config axis splits over the shard devices
(:func:`repro_torch.device.shard_devices`: every visible card, or
``REPRO_TORCH_SHARDS`` forced shards): ``simulate_batch(shard=...)`` pads
the batch to a multiple of the shard count, gives each shard a contiguous
block of rows and runs the rollout on all of them in lockstep, with the
early exit agreed across shards.  No value crosses a shard, so the results
equal the unsharded call's bit for bit.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import trace as TR
from repro_torch.device import Shard, resolve_device, shard_devices, splits
from repro_torch.kernels import lock_sim as K
from repro_torch.kernels import ref
from repro_torch.kernels.ref import NO_TICKET

from . import policy as P

#: Hard cap on rollout length.
MAX_STEPS = 200_000
#: Default timesteps fused into one kernel launch by the blocked rollout.
DEFAULT_BLOCK_STEPS = 32

#: Context columns threaded to the transition stage each step
#: (TRANSITION_CONTEXT minus the per-step ``now2``/``stepi``, same order).
_PRM_FIELDS = ("policy", "threads", "dt", "wake", "cs_lo", "cs_hi",
               "ncs_lo", "ncs_hi", "k", "sws_max", "spin_budget", "seed",
               "oracle", "workload", "wl_period", "wl_duty", "wl_burst",
               "wl_spread", "arrival", "arr_rate", "q_cap", "slo", "tb",
               "fault", "flt_rate", "flt_scale", "park_cost")

_CTR = ref.BLOCK_STATE.index("ctr")


# --------------------------------------------------------------------------
# Carrying columns and state across (numpy <-> tensors)
# --------------------------------------------------------------------------
def _as_i32_bits(a: np.ndarray) -> np.ndarray:
    """A writable contiguous copy, uint32 values as int32 bit patterns
    (other dtypes untouched)."""
    a = np.array(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def columns_from_numpy(arrs: dict, device) -> dict:
    """The numpy column dict of ``encode_configs`` (plus ``dt``) as the
    port's column tensors on ``device``: int32 / float32 as encoded, the
    uint32 ``seed`` as its int32 bit pattern."""
    device = resolve_device(device)
    return {k: torch.from_numpy(_as_i32_bits(v)).to(device)
            for k, v in arrs.items()}


def state_from_numpy(state, device) -> tuple:
    """The 17-array carry, or the 28-array open-loop carry (numpy, ``ctr``
    uint32), as tensors on ``device``, ``ctr`` as its int32 bit pattern."""
    device = resolve_device(device)
    n_closed = len(ref.BLOCK_STATE)
    if len(state) not in (n_closed, n_closed + len(ref.OPEN_STATE)):
        raise ValueError(f"expected the {n_closed}-array closed carry or "
                         f"the {n_closed + len(ref.OPEN_STATE)}-array open "
                         f"one, got {len(state)} arrays")
    return tuple(torch.from_numpy(_as_i32_bits(a)).to(device)
                 for a in state)


def state_to_numpy(state) -> tuple:
    """Inverse of :func:`state_from_numpy`: numpy arrays, ``ctr`` uint32."""
    out = [t.detach().cpu().numpy() for t in state]
    out[_CTR] = out[_CTR].view(np.uint32)
    return tuple(out)


# --------------------------------------------------------------------------
# The rollout
# --------------------------------------------------------------------------
def _init_state(cols, T: int, open_loop: bool = False):
    """The 17-array carry (16 transition-state arrays + spin_cpu): every
    thread starts in NCS with a fresh workload-row duration draw plus the
    seeded arrival-order phase offset
    (:func:`repro_torch.kernels.ref.workload_init_rem`).

    With ``open_loop=True`` the 11 OPEN_STATE arrays are appended and the
    threads of open-arrival configs start DONE with no request bound
    (``rem = inf``, ``req_t = -1``): the population is empty until
    requests arrive.  Closed configs in the same batch circulate from
    step 0 exactly as in the closed-loop engine."""
    C = cols["policy"].shape[0]
    dev = cols["policy"].device
    i32, f32 = torch.int32, torch.float32
    tid = torch.arange(T, dtype=i32, device=dev)[None, :]
    active = tid < cols["threads"][:, None]
    ctr0 = torch.zeros((C, T), dtype=i32, device=dev)
    col = lambda k: cols[k][:, None]
    rem0 = ref.workload_init_rem(
        col("seed"), tid.expand(C, T), ctr0, col("ncs_lo"), col("ncs_hi"),
        col("workload"), col("wl_period"), col("wl_duty"), col("wl_burst"),
        col("wl_spread"), col("arrival_phase"))
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    zc = lambda dtype=i32: torch.zeros((C,), dtype=dtype, device=dev)
    zt = lambda: torch.zeros((C, T), dtype=i32, device=dev)
    circulate = active
    if open_loop:
        circulate = active & (cols["arrival"][:, None] == P.AR_CLOSED)
    state = (
        torch.full((C, T), P.DONE, dtype=i32,
                   device=dev).masked_fill(circulate, P.NCS),  # st
        torch.where(circulate, rem0, inf).contiguous(),        # rem
        torch.full((C, T), float("inf"), dtype=f32, device=dev),  # wake_at
        zt(),                                                 # slept
        zt(),                                                 # spun
        ctr0 + 1,                                             # ctr
        torch.full((C, T), NO_TICKET, dtype=i32, device=dev),  # ticket
        zt(),                                                 # completed_pt
        cols["sws_init"].to(i32).clone(),                     # sws
        zc(), zc(), zc(), zc(), zc(), zc(), zc(),  # cnt ewma wuc permits
        #                                    nticket completed wake_count
        zc(f32),                                              # spin_cpu
    )
    if not open_loop:
        return state
    return state + (
        torch.full((C, T), -1.0, dtype=f32, device=dev),      # req_t
        torch.zeros((C, P.QUEUE_MAX), dtype=f32, device=dev),  # qbuf
        torch.zeros((C, P.LAT_NBINS), dtype=i32, device=dev),  # hist
        zc(), zc(), zc(), zc(), zc(), zc(),   # qhead qlen arrived shed
        #                                       departed slo_viol
        zc(f32), zc(f32),                                     # lat_sum occ_int
    )


def _out_dict(state, executed: int, cols, keep_per_thread: bool = True):
    (st, rem, wake_at, slept, spun, ctr, ticket, completed_pt,
     sws, cnt, ewma, wuc, permits, nticket, completed, wake_count,
     spin_cpu) = state[:17]
    ex = torch.tensor(int(executed), dtype=torch.int32,
                      device=completed.device)
    out = {
        "completed": completed,
        "spin_cpu": spin_cpu,
        "wake_count": wake_count,
        "final_sws": sws,
        "t_end": ex.to(torch.float32) * cols["dt"],
        "steps_run": ex.expand(completed.shape).clone(),
    }
    if len(state) > 17:          # open-loop run: the 11 OPEN_STATE arrays
        (req_t, qbuf, hist, qhead, qlen, arrived, shed, departed,
         slo_viol, lat_sum, occ_int) = state[17:]
        T = req_t.shape[1]
        tid = torch.arange(T, dtype=torch.int32,
                           device=completed.device)[None, :]
        act = tid < cols["threads"][:, None]
        busy = (act & (req_t >= 0.0)).sum(-1).to(torch.int32)
        out.update(lat_hist=hist, arrived=arrived, shed=shed,
                   departed=departed, slo_viol=slo_viol, lat_sum=lat_sum,
                   occ_int=occ_int, in_flight=qlen + busy)
    if keep_per_thread:
        out["completed_per_thread"] = completed_pt
    else:
        # fairness on device: max-min completed-CS spread over the active
        # thread slots — the (C, T) array never reaches the host.
        T = completed_pt.shape[1]
        tid = torch.arange(T, dtype=torch.int32,
                           device=completed.device)[None, :]
        act = tid < cols["threads"][:, None]
        big = 2**31 - 1
        mx = completed_pt.masked_fill(~act, -big).max(dim=-1).values
        mn = completed_pt.masked_fill(~act, big).min(dim=-1).values
        out["fairness"] = mx - mn
    return out


def _step_backends(backend: str):
    """The (advance, transitions) pair of the scan rollout: the kernel
    wrappers, or the plain versions."""
    if backend == "kernel":
        return K.lock_sim_step, K.lock_transitions_step
    if backend == "ref":
        return ref.lock_sim_step_ref, ref.lock_transitions_ref
    raise ValueError(f"unknown backend {backend!r} (kernel|ref)")


def _check_kernel_ids(cols, open_loop: bool) -> None:
    """Check the id columns once per rollout, so that no launch has to."""
    K.check_id_columns(cols["policy"], cols["oracle"], cols["workload"],
                       cols["fault"], cols["tb"], cols["arrival"],
                       open_loop=open_loop)


class _ShardRun:
    """One shard's part of a rollout: its column tensors, its carry, and
    the :class:`~repro_torch.device.Shard` under whose device and stream
    all of its work is queued; ``index`` and ``traced`` label its spans
    (:mod:`repro_torch.trace`)."""

    def __init__(self, cols, shard: Shard, T: int, backend: str,
                 open_loop: bool, index: int, traced: bool):
        self.cols, self.shard, self.open_loop = cols, shard, open_loop
        self.index, self.traced = index, traced
        self.rows = cols["policy"].shape[0]
        with shard.scope():
            if backend == "kernel":   # ids checked once here, not per launch
                _check_kernel_ids(cols, open_loop)
            self.has_budget = P.discipline_flags(cols["policy"])[2] > 0
            self.prm = tuple(cols[f] for f in _PRM_FIELDS)
            self.state = _init_state(cols, T, open_loop)
            self.reached = torch.empty_like(self.state[14])

    def scan(self, n_steps: int, advance, transitions):
        """A generator that queues one advance / rewind / transition triple
        per ``next``, ``n_steps`` of them."""
        cols, dt = self.cols, self.cols["dt"]
        with self.shard.scope():
            steps = torch.arange(n_steps, dtype=torch.int32,
                                 device=dt.device)
        for step in range(n_steps):
            with self.shard.scope():
                state = self.state
                st, i = state[0], steps[step]
                i_f = i.to(torch.float32)
                now2 = (i_f + 1.0) * dt
                rem, burn = advance(st, state[1], cols["alpha"],
                                    cols["cores"], dt, self.has_budget)
                rem = ref.fault_rewind(st, rem, cols["alpha"], cols["cores"],
                                       dt, i_f * dt, cols["seed"],
                                       cols["fault"], cols["flt_rate"],
                                       cols["flt_scale"])
                out = transitions(st, rem, *state[2:16], now2, i, *self.prm,
                                  open_state=(state[17:] if self.open_loop
                                              else None))
                self.state = (*out[:16], state[16] + burn,
                              *(out[16:] if self.open_loop else ()))
            yield

    def block(self, block, step0: int, n_sub_steps: int, limit: int) -> None:
        """Queue one launch of the block function from timestep
        ``step0``."""
        s, cols = self.state, self.cols
        with TR.span(self.traced, "rollout.block", self.index), \
                self.shard.scope():
            self.state = block(*s[:17], step0, cols["alpha"], cols["cores"],
                               self.has_budget, *self.prm,
                               n_sub_steps=n_sub_steps, limit=limit,
                               open_state=s[17:] if self.open_loop else None)

    def converged_rows(self, target_cs: int) -> int:
        """How many configs of the shard have completed ``target_cs``
        critical sections: one compare (into a buffer of the shard's, so
        the sum reads int32 with no cast), one reduction, one count read
        back."""
        with TR.span(self.traced, "rollout.flag", self.index), \
                self.shard.scope():
            return int(torch.ge(self.state[14], target_cs,
                                out=self.reached).sum(dtype=torch.int32))

    def result(self, executed: int, keep_per_thread: bool) -> dict:
        """The output dict (:func:`_out_dict`, reduced on the shard's
        device) as numpy arrays."""
        with TR.span(self.traced, "stream.copy_back", self.index), \
                self.shard.scope():
            out = _out_dict(self.state, executed, self.cols, keep_per_thread)
            return {k: v.cpu().numpy() for k, v in out.items()}


def _simulate_core(parts, n_steps: int, T: int, backend: str = "kernel",
                   rollout: str = "blocked",
                   block_steps: int = DEFAULT_BLOCK_STEPS,
                   target_cs: int = 0, early_exit: bool | None = None,
                   keep_per_thread: bool = True, open_loop: bool = False,
                   trace: bool = False):
    """Simulate ``n_steps`` timesteps of every config of every shard.
    ``parts`` lists ``(cols, shard)`` pairs, each shard's column tensors on
    its device.  Returns the output dict as numpy arrays, the shards' rows
    concatenated in order.

    The shards run in lockstep: each step (scan) or block (blocked) is
    queued on every shard, under its device and stream, before anything
    is read back.
    ``rollout="blocked"``: ``ceil(n_steps / block_steps)`` launches of the
    block function a shard, the ``limit`` mask turning the tail block's
    overshoot sub-steps into passthroughs.  With early exit on, the loop
    stops at the first block boundary where every config of every shard
    has completed ``target_cs`` critical sections; the test reads one
    count back per shard and block, the shards after the first one short
    of it skipped (traced: every shard's, for the counters).  No shard
    stops before the others, so every row runs the steps it runs
    unsharded.  ``early_exit=None`` means on iff ``target_cs > 0``.
    ``rollout="scan"``: one advance / rewind / transition triple per step
    (two kernel launches on the kernel backend), no early exit — the
    parity reference.
    ``open_loop=True`` carries the 11 OPEN_STATE arrays as well (28 in
    all) on every rollout and backend.  ``trace`` is the entry's gate
    read (:mod:`repro_torch.trace`): the spans and counters of the
    rollout."""
    n_steps = int(n_steps)
    if early_exit is None:
        early_exit = target_cs > 0
    if backend not in ("kernel", "ref"):
        raise ValueError(f"unknown backend {backend!r} (kernel|ref)")
    if rollout not in ("blocked", "scan"):
        raise ValueError(f"unknown rollout {rollout!r} (blocked|scan)")
    with TR.span(trace, "rollout.core"):
        runs = [_ShardRun(cols, shard, T, backend, open_loop, i, trace)
                for i, (cols, shard) in enumerate(parts)]
        if rollout == "scan":
            advance, transitions = _step_backends(backend)
            if backend == "kernel":     # ids checked by _ShardRun
                transitions = functools.partial(transitions, ids_checked=True)
            steppers = [r.scan(n_steps, advance, transitions) for r in runs]
            for _ in range(n_steps):
                for s in steppers:
                    next(s)
            executed = n_steps
        else:
            if backend == "kernel":     # ids checked by _ShardRun
                block = functools.partial(K.lock_sim_block, ids_checked=True,
                                          trace=trace)
            else:
                block = ref.lock_sim_block_ref
            B = max(1, int(block_steps))
            n_blocks = (n_steps + B - 1) // B
            nblk, done = 0, False
            at = [0] * len(runs)    # rows at target when the block starts
            while nblk < n_blocks and not done:
                steps = min(B, n_steps - nblk * B)
                for r, a in zip(runs, at):
                    r.block(block, nblk * B, B, n_steps)
                    TR.count(trace, "rollout.row_steps", r.rows * steps)
                    if early_exit:
                        TR.count(trace, "rollout.done_row_steps", a * steps)
                nblk += 1
                if early_exit:      # the exit is agreed across shards
                    done = True
                    for i, r in enumerate(runs):
                        at[i] = r.converged_rows(target_cs)
                        done = done and at[i] == r.rows
                        if not (done or trace):
                            break   # untraced, one shard short decides
            executed = min(nblk * B, n_steps)
    outs = [r.result(executed, keep_per_thread) for r in runs]
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def _pad_rows(arrs: dict, n: int) -> dict:
    """Pad every column to ``n`` rows with copies of the last row: the
    copies run as their source row does, so the early exit and every
    result are unchanged once they are sliced off."""
    C = arrs["policy"].shape[0]
    if n <= C:
        return arrs
    return {k: np.concatenate([v, np.repeat(v[-1:], n - C, axis=0)])
            for k, v in arrs.items()}


def _shards(shard: bool | None, device: torch.device) -> list[Shard]:
    """The shards of a run on ``device``: the shard devices
    (:func:`repro_torch.device.shard_devices`) when splitting —
    ``shard=None`` splits iff there is more than one — else the device
    itself on its current stream."""
    return shard_devices(device) if splits(shard, device) else [Shard(device)]


def _simulate_sharded(arrs, shards: list[Shard], n_steps: int, T: int,
                      trace: bool = False, **kw) -> dict:
    """Run an encoded column dict (numpy, ``encode_configs`` output plus
    ``dt``) split over ``shards``: the config axis padded to a multiple of
    the shard count (:func:`_pad_rows`), one contiguous block of rows
    carried to each shard's device, :func:`_simulate_core` over all of
    them in lockstep, the padding sliced off.  ``trace`` is the entry's
    gate read; ``kw`` are :func:`_simulate_core`'s.  Returns the output
    dict as numpy arrays."""
    n = len(shards)
    C = arrs["policy"].shape[0]
    arrs = _pad_rows(arrs, C + (-C) % n)
    m = arrs["policy"].shape[0] // n
    parts = []
    for i, shard in enumerate(shards):
        with TR.span(trace, "stream.copy_in", i), shard.scope():
            parts.append((columns_from_numpy(
                {k: v[i * m:(i + 1) * m] for k, v in arrs.items()},
                shard.device), shard))
    out = _simulate_core(parts, n_steps, T, trace=trace, **kw)
    return {k: v[:C] for k, v in out.items()}


def simulate_columns(arrs, n_steps: int, *, T: int, backend: str = "kernel",
                     block_steps: int = DEFAULT_BLOCK_STEPS,
                     target_cs: int = 0, keep_per_thread: bool = True,
                     open_loop: bool = False, shard: bool | None = None,
                     device=None) -> dict:
    """One batched run of an encoded column dict (``encode_configs``
    output plus ``dt``, numpy) through the blocked rollout: the horizon
    and ``target_cs`` are plain ints, early exit is on iff
    ``target_cs > 0``; ``shard`` as in :func:`simulate_batch`.  Returns
    the output dict as numpy arrays.  This is the streamed sweep's entry
    (:mod:`repro_torch.core.stream`), the counterpart of the reference's
    ``_simulate_dyn`` and ``_simulate_sharded``."""
    return _simulate_sharded(
        arrs, _shards(shard, resolve_device(device)), int(n_steps), int(T),
        trace=TR.gate(), backend=backend, rollout="blocked",
        block_steps=int(block_steps), target_cs=int(target_cs),
        early_exit=int(target_cs) > 0, keep_per_thread=keep_per_thread,
        open_loop=open_loop)

# --------------------------------------------------------------------------
# Scheduling heuristics + public API
# --------------------------------------------------------------------------
def plan_schedule(configs, target_cs: int = 300):
    """Pick per-config ``dt`` and per-config planned step counts.

    ``dt`` resolves the fastest load-bearing timescale (the *base* CS
    length and wake latency); each config's step count covers
    ~``target_cs`` critical sections for that cell, with the mean CS/NCS
    durations corrected for the config's workload row.  Returns
    ``(dt, steps)``: (C,) float32 timesteps and (C,) int64 planned counts,
    unclamped — :func:`simulate_batch` runs ``steps.max()`` for the whole
    batch (or per bucket with ``bucket_steps=True``), capped at
    :data:`MAX_STEPS` with a diagnostic naming the cells the cap
    under-samples."""
    return plan_schedule_columns(P.config_columns(configs), target_cs)


def plan_schedule_columns(cols, target_cs: int = 300):
    """:func:`plan_schedule` over RAW struct-of-arrays columns
    (:data:`repro_torch.core.policy.RAW_CONFIG_FIELDS`).  All arithmetic
    is float64 numpy, elementwise-identical to the per-object path."""
    cs_lo = np.asarray(cols["cs_lo"], np.float64)
    cs_hi = np.asarray(cols["cs_hi"], np.float64)
    ncs_lo = np.asarray(cols["ncs_lo"], np.float64)
    ncs_hi = np.asarray(cols["ncs_hi"], np.float64)
    wake = (np.asarray(cols["wake_latency"], np.float64)
            * np.asarray(cols.get("park_cost", 1.0), np.float64))
    threads = np.asarray(cols["threads"], np.int64)
    cores = np.asarray(cols["cores"], np.int64)
    cs_scale, ncs_scale = P.workload_mean_scale_columns(
        cols["workload"], cols["wl_duty"], cols["wl_burst"],
        cols["wl_spread"])
    cs_b = (cs_lo + cs_hi) / 2.0
    cs_m = cs_b * cs_scale
    ncs_m = (ncs_lo + ncs_hi) / 2.0 * ncs_scale
    dt = np.minimum(np.maximum(cs_b, 1e-8), np.maximum(wake, 1e-8)) / 6.0
    per_cs = (np.maximum(cs_m, (cs_m + ncs_m) / np.minimum(threads, cores))
              * 1.35 + 0.25 * wake + 2.0 * dt)
    steps = np.ceil(target_cs * per_cs / dt).astype(np.int64)
    return dt.astype(np.float32), steps


def plan_buckets(steps) -> list[np.ndarray]:
    """Group config indices into power-of-two buckets of planned step
    count (``ceil(log2(steps))``), ascending.  Within a bucket the shared
    rollout length (the bucket max) is at most 2x any member's own plan."""
    ids = np.ceil(np.log2(np.maximum(np.asarray(steps), 1))).astype(int)
    return [np.nonzero(ids == b)[0] for b in np.unique(ids)]


def _warn_undersampled(configs, steps, cap: int, target_cs: int,
                       bucketed: bool = False) -> None:
    """Step-cap diagnostic: name which cells under-sample ``target_cs``
    (count + worst offender) instead of one generic warning."""
    import warnings

    steps = np.asarray(steps)
    over = np.nonzero(steps > cap)[0]
    worst = int(steps.argmax())
    c = configs[worst]
    expect = int(target_cs * cap / steps[worst])
    advice = ("the truncated cells need a shorter horizon (smaller "
              "target_cs) or a split sweep"
              if bucketed else
              "bucket_steps=True keeps fast cells fully sampled; the "
              "truncated cells need a shorter horizon (smaller "
              "target_cs) or a split sweep")
    warnings.warn(
        f"step cap {cap} truncates {len(over)}/{len(configs)} configs "
        f"below target_cs={target_cs}; worst offender is config {worst} "
        f"({c.lock}, threads={c.threads}, cores={c.cores}, "
        f"cs<={c.cs[1]:.3g}s, ncs<={c.ncs[1]:.3g}s, "
        f"wake={c.wake_latency:.3g}s): planned {int(steps[worst])} steps, "
        f"expect ~{expect} completed CS.  {advice}.", stacklevel=3)


@dataclass
class BatchResult:
    """Struct-of-arrays results for one batched run (numpy, length C)."""

    configs: list
    n_steps: int
    backend: str
    dt: np.ndarray
    t_end: np.ndarray
    completed: np.ndarray
    spin_cpu: np.ndarray
    wake_count: np.ndarray
    final_sws: np.ndarray
    #: (C, T) per-slot CS counts; ``None`` when the run was made with
    #: ``keep_per_thread=False`` (``fairness`` carries the on-device
    #: spread instead).
    completed_per_thread: np.ndarray | None = None
    #: (C,) timesteps actually executed per config — less than ``n_steps``
    #: when early exit fired, and per-bucket under ``bucket_steps=True``.
    steps_run: np.ndarray | None = None
    #: (C,) max-min completed-CS spread over active threads, computed on
    #: device when ``keep_per_thread=False``.
    fairness: np.ndarray | None = None
    #: Open-loop outputs, ``None`` on closed-loop runs: (C, LAT_NBINS)
    #: per-request latency histogram (log-spaced bins,
    #: :func:`repro_torch.core.policy.latency_bin_edges`) plus (C,)
    #: request counters — arrivals offered, shed at the full queue,
    #: departed, SLO violations among departures — and the exact latency /
    #: occupancy-integral accumulators behind Little's law
    #: (``occ_int = ∫L dt``, ``lat_sum = Σ latency``).  ``in_flight`` is
    #: the end-of-run system occupancy (queued + bound to a thread).
    lat_hist: np.ndarray | None = None
    arrived: np.ndarray | None = None
    shed: np.ndarray | None = None
    departed: np.ndarray | None = None
    slo_viol: np.ndarray | None = None
    lat_sum: np.ndarray | None = None
    occ_int: np.ndarray | None = None
    in_flight: np.ndarray | None = None

    @property
    def throughput(self) -> np.ndarray:
        return self.completed / np.maximum(self.t_end, 1e-30)

    @property
    def sync_cpu_per_cs(self) -> np.ndarray:
        return self.spin_cpu / np.maximum(self.completed, 1)

    def latency_quantiles(self, qs=(0.50, 0.95, 0.99)) -> np.ndarray:
        """(len(qs), C) per-request latency percentiles from the on-device
        histogram (geometric bin midpoints; NaN where nothing departed)."""
        if self.lat_hist is None:
            raise ValueError("closed-loop run: no latency histogram")
        return P.latency_percentiles(self.lat_hist, qs)

    @property
    def p50(self) -> np.ndarray:
        return self.latency_quantiles((0.50,))[0]

    @property
    def p95(self) -> np.ndarray:
        return self.latency_quantiles((0.95,))[0]

    @property
    def p99(self) -> np.ndarray:
        return self.latency_quantiles((0.99,))[0]

    @property
    def slo_frac(self) -> np.ndarray:
        """Fraction of departed requests whose latency exceeded the
        config's SLO (NaN where nothing departed)."""
        if self.slo_viol is None:
            raise ValueError("closed-loop run: no SLO accounting")
        dep = np.asarray(self.departed, np.float64)
        return np.where(dep > 0, self.slo_viol / np.maximum(dep, 1.0),
                        np.nan)

    @property
    def mean_latency(self) -> np.ndarray:
        """Exact mean departed-request latency (NaN where none departed)."""
        if self.lat_sum is None:
            raise ValueError("closed-loop run: no latency accounting")
        dep = np.asarray(self.departed, np.float64)
        return np.where(dep > 0, self.lat_sum / np.maximum(dep, 1.0),
                        np.nan)

    def validate(self, where: str = "batch") -> "BatchResult":
        """Fail loudly on engine non-finites, naming the offending config
        (:func:`check_finite`).  Returns ``self`` so call sites can chain
        it."""
        return check_finite(self, where, self.configs)

    def fairness_spread(self, i: int) -> int:
        """Max-min completed-CS spread across config ``i``'s threads —
        ~0/1 under FIFO ticket grants, unbounded under barging locks."""
        if self.completed_per_thread is None:
            return int(self.fairness[i])
        per = self.completed_per_thread[i, :self.configs[i].threads]
        return int(per.max() - per.min())

    def row(self, i: int) -> dict:
        return {
            "config": self.configs[i],
            "completed_cs": int(self.completed[i]),
            "throughput": float(self.throughput[i]),
            "sync_cpu_per_cs": float(self.sync_cpu_per_cs[i]),
            "wake_count": int(self.wake_count[i]),
            "final_sws": int(self.final_sws[i]),
            "t_end": float(self.t_end[i]),
        }


def check_finite(res, where: str, configs=None):
    """Raise ``ValueError`` on an engine non-finite in the summary of a
    :class:`BatchResult` or a streamed sweep, naming the first offending
    config (and its parameters when ``configs`` is given): throughput,
    spin CPU, wake counts and windows must be finite for every config,
    and so must the open-loop accumulators.  Latency quantiles,
    ``mean_latency`` and ``slo_frac`` are NaN by design where no request
    departed, so they are checked only where ``departed > 0``.  Returns
    ``res``."""
    checks = [("t_end", res.t_end), ("completed", res.completed),
              ("spin_cpu", res.spin_cpu), ("wake_count", res.wake_count),
              ("final_sws", res.final_sws), ("throughput", res.throughput),
              ("sync_cpu_per_cs", res.sync_cpu_per_cs)]
    if res.lat_hist is not None:
        dep = np.asarray(res.departed, np.int64)
        mean_lat = np.where(dep > 0, res.lat_sum / np.maximum(dep, 1.0),
                            np.nan)
        checks += [("lat_sum", res.lat_sum), ("occ_int", res.occ_int),
                   ("mean_latency", np.where(dep > 0, mean_lat, 0.0)),
                   ("slo_frac", np.where(dep > 0, res.slo_frac, 0.0)),
                   ("p50", np.where(dep > 0, res.p50, 0.0))]
    for name, arr in checks:
        a = np.asarray(arr, np.float64)
        badm = ~np.isfinite(a)
        if badm.any():
            i = int(np.nonzero(badm)[0][0])
            cfg = ("" if configs is None else
                   f": {configs[i]!r}" if i < len(configs)
                   else ": <padded row>")
            raise ValueError(f"non-finite {name}={a[i]!r} at config {i} "
                             f"in {where}{cfg}")
    return res


def _pad_quantum(n: int) -> int:
    """Next power of two — the config-axis padding quantum of the bucketed
    path, so buckets of nearby sizes land on the same padded shape."""
    return 1 << max(int(n) - 1, 0).bit_length()


_RESULT_FIELDS = ("dt", "t_end", "completed", "spin_cpu", "wake_count",
                  "final_sws", "steps_run")
#: BatchResult fields of an open-loop run.
OPEN_RESULT_FIELDS = ("lat_hist", "arrived", "shed", "departed", "slo_viol",
                      "lat_sum", "occ_int", "in_flight")


def _simulate_bucketed(configs, buckets, steps, *, target_cs, dt, backend,
                       max_threads, shard, rollout, block_steps,
                       early_exit, keep_per_thread, open_loop,
                       device) -> BatchResult:
    """Run each step-count bucket as its own batched call and stitch the
    per-config results back into the caller's row order.  ``dt`` and
    ``steps`` are the (C,) planned arrays — passed down sliced, so the
    per-bucket calls skip re-planning.  Each bucket's config axis is
    padded to the next power of two (copies of its last row, sliced off
    again), as the reference does; a split divides each padded bucket
    over the shards.  ``open_loop`` is resolved once by the
    caller and forced on every bucket, so a mixed batch whose open configs
    all land in one bucket still returns open-loop outputs for every
    row."""
    C = len(configs)
    T = max_threads or max(c.threads for c in configs)
    parts = [simulate_batch(
        [configs[i] for i in idx], target_cs=target_cs,
        dt=np.asarray(dt)[idx],
        n_steps=min(int(steps[idx].max()), MAX_STEPS),
        backend=backend, max_threads=T, shard=shard, rollout=rollout,
        block_steps=block_steps, early_exit=early_exit,
        bucket_steps=False, keep_per_thread=keep_per_thread,
        open_loop=open_loop,
        pad_configs=_pad_quantum(len(idx)) if rollout == "blocked"
        else None, device=device) for idx in buckets]
    fields = _RESULT_FIELDS + (("completed_per_thread",) if keep_per_thread
                               else ("fairness",)) \
        + (OPEN_RESULT_FIELDS if open_loop else ())
    merged = {}
    for f in fields:
        first = getattr(parts[0], f)
        merged[f] = np.empty((C,) + first.shape[1:], first.dtype)
        for idx, p in zip(buckets, parts):
            merged[f][idx] = getattr(p, f)
    return BatchResult(configs=configs,
                       n_steps=max(p.n_steps for p in parts),
                       backend=backend, **merged)


def simulate_batch(configs, *, target_cs: int = 300,
                   n_steps: int | None = None, dt=None,
                   backend: str = "kernel",
                   max_threads: int | None = None,
                   shard: bool | None = None, rollout: str = "blocked",
                   block_steps: int | None = None,
                   early_exit: bool | None = None,
                   bucket_steps: bool = False,
                   keep_per_thread: bool = True,
                   pad_configs: int | None = None,
                   open_loop: bool | None = None,
                   device=None) -> BatchResult:
    """Simulate every :class:`repro_torch.core.policy.SimConfig` in
    ``configs`` in one batched device program (or one per step-count
    bucket).

    All configurations in a call share the rollout length; each carries
    its own ``dt``.  ``backend="kernel"`` (default) goes through
    :func:`repro_torch.kernels.lock_sim.lock_sim_block`;
    ``backend="ref"`` through the plain PyTorch versions on the same
    device.  ``device=None`` is the card (raises without CUDA);
    ``device="cpu"`` runs the plain versions on the host.

    * ``rollout="blocked"`` (default) fuses ``block_steps`` timesteps
      (default :data:`DEFAULT_BLOCK_STEPS`) into one launch per loop
      iteration — bit-identical to ``rollout="scan"``, the per-step parity
      reference (a :func:`~repro_torch.kernels.lock_sim.lock_sim_step` and
      a :func:`~repro_torch.kernels.lock_sim.lock_transitions_step` launch
      per step on the kernel backend).
    * ``early_exit`` (default: on iff ``n_steps`` is auto-planned) stops
      the blocked rollout at the first block boundary where every config
      has completed ``target_cs`` critical sections;
      ``BatchResult.steps_run`` records the executed count.  Ignored
      under ``rollout="scan"``.
    * ``bucket_steps=True`` groups configs into power-of-two buckets of
      planned step count (:func:`plan_buckets`) and runs one call per
      bucket, so slow cells no longer pin fast cells to their horizon.
    * ``keep_per_thread=False`` drops the (C, T) ``completed_per_thread``
      output; the fairness spread is reduced on device into
      ``BatchResult.fairness`` instead.
    * ``pad_configs`` pads the batch with copies of the last config up to
      the given count (results sliced back); results are unchanged
      because configs are independent.
    * ``shard`` splits the config axis over the shard devices
      (:func:`repro_torch.device.shard_devices`: every visible card, or
      ``REPRO_TORCH_SHARDS`` forced shards): ``None`` (default) iff there
      is more than one, ``True`` always (one shard on one card still runs
      the split, on a stream of its own), ``False`` never.  The batch is
      padded to a multiple of the shard count, each shard runs a
      contiguous block of rows, and all run in lockstep with the early
      exit agreed across them: every field equals the unsharded run's bit
      for bit.  A shard that fails raises; nothing falls back.

    ``open_loop=None`` (auto) switches on the open-loop arrival engine iff
    any config has a non-closed arrival row; a closed batch carries no
    OPEN_STATE arrays.  Forcing ``open_loop=True`` on an all-closed batch
    is valid — the open machinery runs but stays inert (rate 0 admits
    nothing) and every closed output is unchanged.
    """
    traced = TR.gate()
    configs = list(configs)
    if open_loop is None:
        open_loop = any(c.open_loop for c in configs)
    device = resolve_device(device)
    if dt is None or n_steps is None:
        auto_dt, steps_arr = plan_schedule(configs, target_cs)
    if bucket_steps and n_steps is None and len(configs) > 1:
        buckets = plan_buckets(steps_arr)
        if len(buckets) > 1:
            if int(steps_arr.max()) > MAX_STEPS:
                _warn_undersampled(configs, steps_arr, MAX_STEPS,
                                   target_cs, bucketed=True)
            if dt is None:
                dt = auto_dt
            else:
                dt = np.broadcast_to(np.asarray(dt, np.float32),
                                     (len(configs),)).copy()
            return _simulate_bucketed(
                configs, buckets, steps_arr, target_cs=target_cs, dt=dt,
                backend=backend, max_threads=max_threads, shard=shard,
                rollout=rollout, block_steps=block_steps,
                # a bucketed horizon is auto-planned: exit by default
                early_exit=True if early_exit is None else early_exit,
                keep_per_thread=keep_per_thread, open_loop=open_loop,
                device=device)
    arrs = P.encode_configs(configs)
    if dt is None:
        dt = auto_dt
    else:
        dt = np.broadcast_to(np.asarray(dt, np.float32),
                             arrs["policy"].shape).copy()
    if n_steps is None:
        auto_steps = int(steps_arr.max())
        if auto_steps > MAX_STEPS:
            _warn_undersampled(configs, steps_arr, MAX_STEPS, target_cs,
                               bucketed=bucket_steps)
        n_steps = min(auto_steps, MAX_STEPS)
        if early_exit is None:
            early_exit = True
    elif early_exit is None:
        early_exit = False       # a pinned horizon means: run exactly it
    if n_steps > MAX_STEPS:
        raise ValueError(f"n_steps={n_steps} exceeds MAX_STEPS={MAX_STEPS}")
    arrs["dt"] = np.asarray(dt, np.float32)
    C = len(configs)
    if pad_configs is not None:
        arrs = _pad_rows(arrs, pad_configs)
    T = max_threads or int(arrs["threads"].max())
    if T < int(arrs["threads"].max()):
        raise ValueError("max_threads smaller than widest config")
    if block_steps is None:
        block_steps = DEFAULT_BLOCK_STEPS
    tc = int(target_cs) if (early_exit and rollout == "blocked") else 0
    out = _simulate_sharded(arrs, _shards(shard, device), int(n_steps),
                            int(T), trace=traced, backend=backend,
                            rollout=rollout, block_steps=int(block_steps),
                            target_cs=tc,
                            early_exit=tc > 0,
                            keep_per_thread=keep_per_thread,
                            open_loop=bool(open_loop))
    out = {k: v[:C] for k, v in out.items()}
    return BatchResult(configs=configs, n_steps=int(n_steps), backend=backend,
                       dt=np.asarray(dt, np.float32)[:C],
                       t_end=out["t_end"], completed=out["completed"],
                       spin_cpu=out["spin_cpu"],
                       wake_count=out["wake_count"],
                       final_sws=out["final_sws"],
                       completed_per_thread=out.get("completed_per_thread"),
                       steps_run=out["steps_run"],
                       fairness=out.get("fairness"),
                       **{f: out.get(f) for f in OPEN_RESULT_FIELDS})
