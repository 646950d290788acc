"""stream — memory-budgeted streaming sweeps over the port's xdes engine.

The port of ``repro/core/stream.py``.  :func:`repro_torch.core.xdes.
simulate_batch` is one batched run per call: at 10^5-10^6 configs its
working set — eight ``(C, T)`` state arrays carried through the blocked
rollout, plus the full raw :class:`~repro_torch.core.xdes.BatchResult` on
the host — outgrows device memory and host RAM.  :func:`sweep_stream` runs
the same blocked (and optionally bucketed) rollout chunk by chunk instead:

* **Chunk size from a memory model.**  :func:`bytes_per_config` prices the
  rollout's working set per config; :func:`memory_budget_bytes` resolves
  the budget — an explicit ``mem_mb``, the ``REPRO_SWEEP_MEM_MB`` env
  var, :data:`DEVICE_MEM_FRACTION` of the card's memory, else a CPU
  default — and :func:`plan_chunks` divides the two, rounded down to a
  multiple of ``reduce.group`` so reduction groups never straddle a chunk
  boundary.  Each chunk runs its real rows only: the kernel compiles
  nothing per shape, so there is no shape ladder to pad onto.
* **On-device reduction.**  Chunks run ``keep_per_thread=False``: the
  ``(chunk, T)`` state reduces on the device to per-config summary
  columns, and only those reach the host.  An optional
  :class:`CellReduce` folds each chunk into an ``(n_cells, group)``
  win-count tensor on the device (throughput argmax per consecutive
  ``group``-row block — the phase-diagram accumulation).
* **Composition.**  ``bucket_steps=True`` buckets the global step plan
  before chunking, so per-config horizons match the one-shot bucketed
  path.  With ``early_exit=False`` results are bit-identical to one-shot
  ``simulate_batch`` and invariant to chunk boundaries (configs are
  independent).
* **Self-healing.**  ``checkpoint_dir=`` checkpoints the summary columns,
  the win counts and the chunk cursor after every committed chunk through
  :class:`repro_torch.checkpoint.manager.CheckpointManager` (the
  reference's on-disk layout); ``resume=True`` restores the latest
  checkpoint (guarded by a sweep-plan fingerprint) and skips the
  committed chunks.  A chunk that dies with ``torch.cuda.OutOfMemoryError``
  is retried as two half chunks, down to one reduction group; any other
  error propagates unchanged.  Non-finite summaries are quarantined into
  ``StreamResult.failures`` and sanitized before the win reduction.

Feed it RAW column arrays (:data:`repro_torch.core.policy.
RAW_CONFIG_FIELDS`, e.g. from the ``*_columns`` builders of
:mod:`repro_torch.configs.catalog`) or a list of
:class:`~repro_torch.core.policy.SimConfig`.  ``device=None`` is the card
(raises without CUDA); ``shard=True`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import hashlib
import json
import os
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

from . import policy as P
from . import xdes

#: Environment variable naming the sweep memory budget in MiB.
ENV_MEM_MB = "REPRO_SWEEP_MEM_MB"
#: Fallback budget (MiB) when neither an explicit ``mem_mb``, the env
#: var, nor a CUDA device is given (CPU runs).
DEFAULT_MEM_MB = 512.0
#: Fraction of the card's total memory the sweep may claim (headroom for
#: the allocator's own caching and other tensors).
DEVICE_MEM_FRACTION = 0.6

#: The blocked rollout's working set, per config (see bytes_per_config):
#: (C, T) state arrays carried through the rollout...
_STATE_PT_ARRAYS = 8     # st, rem, wake_at, slept, spun, ctr, ticket, cpt
#: ...plus (C,) carries (sws..wake_count, spin_cpu),
_STATE_PC_ARRAYS = 9
#: the encoded input columns (CONFIG_FIELDS + dt),
_IN_COLS = len(P.CONFIG_FIELDS) + 1
#: and the summary output columns.
_OUT_COLS = 7

#: Per-config summary columns a streamed chunk reduces to on the device.
SUMMARY_FIELDS = ("completed", "spin_cpu", "wake_count", "final_sws",
                  "t_end", "steps_run", "fairness")

#: Extra (C,) summary columns of an open-loop stream (the (C, LAT_NBINS)
#: ``lat_hist`` histogram rides along separately).
OPEN_SUMMARY_FIELDS = ("arrived", "shed", "departed", "slo_viol",
                       "lat_sum", "occ_int", "in_flight")

#: Open-loop integer summary columns (the rest are float32).
_OPEN_INT_FIELDS = ("arrived", "shed", "departed", "slo_viol", "in_flight")


def bytes_per_config(T: int, *, dtype_bytes: int = 4,
                     double_buffer: int = 2,
                     open_loop: bool = False) -> int:
    """Modelled device working set of one config at ``T`` thread slots.

    Every state/input/output element is 4 bytes.  The ``(C, T)`` state
    block is counted ``double_buffer`` times: a launch reads the old carry
    and writes a fresh one, and both are alive until the old is released.

    ``open_loop=True`` adds the 11 OPEN_STATE carry arrays: one more
    ``(C, T)`` block (``req_t``), the ``(C, QUEUE_MAX)`` ring buffer and
    ``(C, LAT_NBINS)`` histogram, and 8 more per-config counters.
    """
    pt_arrays = _STATE_PT_ARRAYS + (1 if open_loop else 0)
    per_thread = pt_arrays * dtype_bytes * int(T) * double_buffer
    per_config = dtype_bytes * (_STATE_PC_ARRAYS * double_buffer
                                + _IN_COLS + _OUT_COLS)
    if open_loop:
        per_config += dtype_bytes * (
            (P.QUEUE_MAX + P.LAT_NBINS + 8) * double_buffer
            + len(OPEN_SUMMARY_FIELDS) + P.LAT_NBINS)
    return per_thread + per_config


def memory_budget_bytes(mem_mb: float | None = None, device=None) -> int:
    """Resolve the sweep memory budget in bytes.

    Priority: explicit ``mem_mb`` > ``REPRO_SWEEP_MEM_MB`` env var >
    :data:`DEVICE_MEM_FRACTION` of the CUDA device's total memory
    (``torch.cuda.mem_get_info``) > :data:`DEFAULT_MEM_MB` on the CPU.
    ``device=None`` is the card, as everywhere in the port.
    """
    if mem_mb is None:
        env = os.environ.get(ENV_MEM_MB)
        if env:
            mem_mb = float(env)
    if mem_mb is not None:
        return int(float(mem_mb) * 2**20)
    device = xdes.resolve_device(device)
    if device.type == "cuda":
        return int(DEVICE_MEM_FRACTION * torch.cuda.mem_get_info(device)[1])
    return int(DEFAULT_MEM_MB * 2**20)


def plan_chunks(C: int, T: int, *, mem_mb: float | None = None,
                quantum: int = 1, open_loop: bool = False,
                device=None) -> int:
    """Chunk size (configs per batched run) for a ``C``-config sweep at
    ``T`` thread slots under the resolved memory budget.

    The chunk is the largest multiple of ``quantum`` whose modelled
    working set (:func:`bytes_per_config`) fits the budget
    (:func:`memory_budget_bytes`), so reduction groups divide it evenly.
    Floor: one ``quantum`` (a warning names the overshoot when even that
    exceeds the budget).  Never larger than needed for ``C``.  (The
    reference rounds down further, to ``quantum x power-of-two``, to reuse
    compiled shapes; the CUDA kernel has none to reuse.)
    """
    if C < 1 or T < 1 or quantum < 1:
        raise ValueError("C, T and quantum must be >= 1")
    budget = memory_budget_bytes(mem_mb, device)
    bpc = bytes_per_config(T, open_loop=open_loop)
    raw = budget // bpc
    if raw < quantum:
        warnings.warn(
            f"sweep memory budget {budget / 2**20:.0f} MiB is below one "
            f"reduction quantum of {quantum} configs at T={T} "
            f"(~{quantum * bpc / 2**20:.1f} MiB); "
            f"streaming at the quantum floor.", stacklevel=2)
        return quantum
    return min(quantum * (raw // quantum), quantum * -(-C // quantum))


@dataclass(frozen=True)
class CellReduce:
    """Phase-diagram accumulation spec for :func:`sweep_stream`.

    Rows are consumed in consecutive blocks of ``group`` (e.g. the V
    (discipline, oracle) variants of one scenario, row order of the
    catalog sweeps); each block's throughput argmax is its winner, and
    ``cell_ids[g]`` names the phase-diagram cell block ``g`` belongs to.
    The stream folds every chunk into an ``(n_cells, group)`` int32
    win-count tensor on the device — ``StreamResult.wins``.
    """

    group: int
    cell_ids: np.ndarray
    n_cells: int

    def __post_init__(self):
        ids = np.asarray(self.cell_ids, np.int32)
        object.__setattr__(self, "cell_ids", ids)
        if self.group < 1:
            raise ValueError("group must be >= 1")
        if ids.size and (int(ids.min()) < 0
                         or int(ids.max()) >= self.n_cells):
            raise ValueError("cell_ids out of range")


def _cell_update(wins, completed, t_end, cell_ids, *, group: int):
    """Fold one chunk into the win-count tensor ``wins`` in place:
    throughput argmax per ``group``-row block (the first maximum, as
    ``jnp.argmax`` picks it), scatter-add at ``cell_ids`` (-1 ids
    contribute nothing, as in the reference).  Returns ``wins``."""
    thr = completed.to(torch.float32) / torch.clamp(t_end, min=1e-30)
    win = torch.argmax(thr.reshape(-1, group), dim=1)
    ok = cell_ids >= 0
    rows = torch.where(ok, cell_ids, torch.zeros_like(cell_ids))
    wins.index_put_((rows.to(torch.int64), win), ok.to(wins.dtype),
                    accumulate=True)
    return wins


@dataclass
class StreamResult:
    """Per-config summary columns of one streamed sweep (numpy, length
    C) — the same statistics as :class:`repro_torch.core.xdes.
    BatchResult` with ``keep_per_thread=False``, without the configs list
    or any (C, T) array ever reaching the host."""

    n_configs: int
    n_steps: int               # the largest horizon any chunk ran
    backend: str
    dt: np.ndarray
    t_end: np.ndarray
    completed: np.ndarray
    spin_cpu: np.ndarray
    wake_count: np.ndarray
    final_sws: np.ndarray
    steps_run: np.ndarray
    fairness: np.ndarray
    #: Streaming-plan record: configs per batched run, number of runs,
    #: resolved budget, and the bytes/config model behind the chunk size.
    chunk_size: int = 0
    n_chunks: int = 0
    budget_mb: float = 0.0
    bytes_per_config: int = 0
    #: (n_cells, group) win counts when a CellReduce was given.
    wins: np.ndarray | None = None
    #: Quarantined configs: one record per config whose summary came back
    #: non-finite (see :func:`_quarantine`).  Empty on healthy sweeps.
    failures: list = field(default_factory=list)
    #: Chunks restored from a checkpoint instead of recomputed.
    resumed_chunks: int = 0
    #: Open-loop outputs (``None`` on closed sweeps): the (C, LAT_NBINS)
    #: latency histogram and the (C,) request counters / accumulators —
    #: same semantics as :class:`repro_torch.core.xdes.BatchResult`.
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

    def fairness_spread(self, i: int) -> int:
        return int(self.fairness[i])

    def latency_quantiles(self, qs=(0.50, 0.95, 0.99)) -> np.ndarray:
        """(len(qs), C) per-request latency percentiles from the streamed
        histogram (NaN where nothing departed)."""
        if self.lat_hist is None:
            raise ValueError("closed-loop sweep: no latency histogram")
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
        if self.slo_viol is None:
            raise ValueError("closed-loop sweep: no SLO accounting")
        dep = np.asarray(self.departed, np.float64)
        return np.where(dep > 0, self.slo_viol / np.maximum(dep, 1.0),
                        np.nan)

    def validate(self, where: str = "sweep") -> "StreamResult":
        """Fail loudly on engine non-finites, naming the first offending
        config — the check of :meth:`repro_torch.core.xdes.BatchResult.
        validate` (:func:`repro_torch.core.xdes.check_finite`).  Returns
        ``self``."""
        return xdes.check_finite(self, where)


def _run_chunk(arrs, n_steps: int, T: int, backend: str, block_steps: int,
               target_cs: int, open_loop: bool, device):
    """One batched run on an encoded chunk: the blocked rollout,
    ``keep_per_thread=False`` (summaries reduce on the device)."""
    return xdes.simulate_columns(
        arrs, int(n_steps), T=T, backend=backend, block_steps=block_steps,
        target_cs=target_cs, keep_per_thread=False, open_loop=open_loop,
        device=device)


def _run_chunk_resilient(part, horizon, T, backend, block_steps, target_cs,
                         open_loop, group: int, device, verbose: bool = False):
    """Run one chunk with halving backoff: ``torch.cuda.OutOfMemoryError``
    — and only that — splits the chunk into two group-aligned halves and
    retries each, recursively down to one reduction group.  Returns the
    summary dict of the chunk's rows."""
    n = part["policy"].shape[0]
    try:
        res = _run_chunk(part, horizon, T, backend, block_steps, target_cs,
                         open_loop, device)
        return {k: np.asarray(v) for k, v in res.items()}
    except torch.cuda.OutOfMemoryError as e:
        if n <= group:
            raise
        if torch.cuda.is_available():
            torch.cuda.empty_cache()       # give the halves the freed blocks
        mid = group * max(1, (n // 2) // group)
        if verbose:
            print(f"  stream chunk of {n} configs hit "
                  f"{type(e).__name__}; retrying as {mid} + {n - mid}")
        warnings.warn(
            f"sweep chunk of {n} configs failed with an allocation error; "
            f"retrying with halved chunks ({mid} + {n - mid})",
            stacklevel=2)
    halves = [_run_chunk_resilient(
        {k: v[lo:hi] for k, v in part.items()}, horizon, T, backend,
        block_steps, target_cs, open_loop, group, device, verbose)
        for lo, hi in ((0, mid), (mid, n))]
    return {k: np.concatenate([h[k] for h in halves]) for k in halves[0]}


#: Float summary columns scanned for engine non-finites (intentional NaN
#: lives only in DERIVED statistics of empty histograms, never in these).
_FINITE_FIELDS = ("t_end", "spin_cpu", "lat_sum", "occ_int")


def _quarantine(res: dict, cols, sel_index: np.ndarray, failures: list):
    """Detect non-finite summary values in one chunk's results.

    Appends one structured record per offending config to ``failures``
    (global config index, the non-finite fields, and the config's raw
    column values for reproduction) and returns a per-row bad mask.  The
    caller feeds SANITIZED copies to the win-count reduction; the raw
    values stay visible in the summary columns."""
    bad = np.zeros(sel_index.shape[0], bool)
    for f in _FINITE_FIELDS:
        if f in res:
            bad |= ~np.isfinite(np.asarray(res[f], np.float64))
    if not bad.any():
        return bad
    for i in np.nonzero(bad)[0]:
        gi = int(sel_index[i])
        failures.append({
            "index": gi,
            "fields": {f: float(np.asarray(res[f], np.float64)[i])
                       for f in _FINITE_FIELDS if f in res
                       and not np.isfinite(np.asarray(res[f],
                                                      np.float64)[i])},
            "config": {k: (v[gi].item() if np.asarray(v).ndim else
                           np.asarray(v).item())
                       for k, v in cols.items()},
        })
    return bad


def _write_failures(path: str, n_configs: int, failures: list) -> None:
    """Atomically write the structured quarantine report (tmp+rename,
    same crash-safety contract as the checkpoint layout)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"n_configs": n_configs, "n_failures": len(failures),
                   "failures": failures}, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def _plan_fingerprint(arrs, *, chunk, T, n_steps, target_cs, backend,
                      bucket_steps, shard, group) -> np.ndarray:
    """Digest of the sweep plan + encoded inputs: a checkpoint written by
    a DIFFERENT sweep (other configs, other chunking) must never be
    resumed into this one."""
    h = hashlib.sha256()
    h.update(repr((int(chunk), int(T), int(n_steps), int(target_cs),
                   str(backend), bool(bucket_steps), bool(shard),
                   int(group))).encode())
    for k in sorted(arrs):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrs[k]).tobytes())
    return np.frombuffer(h.digest(), np.uint8).copy()


def sweep_stream(configs, *, target_cs: int = 300,
                 n_steps: int | None = None, dt=None,
                 backend: str = "kernel",
                 block_steps: int | None = None, shard: bool | None = None,
                 bucket_steps: bool = False, early_exit: bool | None = None,
                 reduce: CellReduce | None = None,
                 mem_mb: float | None = None,
                 max_threads: int | None = None,
                 chunk: int | None = None,
                 strict: bool = True,
                 checkpoint_dir: str | None = None,
                 resume: bool = False,
                 failures_path: str | None = None,
                 verbose: bool = False,
                 device=None) -> StreamResult:
    """Run a sweep chunk by chunk under a memory budget; see the module
    docstring for the mechanism.

    ``configs`` is a RAW column mapping (:data:`repro_torch.core.policy.
    RAW_CONFIG_FIELDS`) or a list of :class:`~repro_torch.core.policy.
    SimConfig`.  Planning (``dt`` + per-config horizons, and the
    ``bucket_steps`` grouping) happens once over the full sweep, so
    per-config horizons match the equivalent one-shot
    :func:`~repro_torch.core.xdes.simulate_batch` call regardless of
    chunking.  ``chunk`` overrides the budget-derived size; ``mem_mb``
    overrides the budget (else env / device / default — see
    :func:`memory_budget_bytes`).  ``early_exit`` defaults to on iff the
    horizon is auto-planned, like ``simulate_batch`` — pass ``False`` for
    chunk-invariant bit-exactness.

    Resilience: ``strict=False`` clamps out-of-range sweep columns instead
    of raising (:func:`repro_torch.core.policy.encode_columns`);
    ``checkpoint_dir`` + ``resume`` give chunk-granular crash recovery;
    out-of-memory chunks retry halved; non-finite summaries are
    quarantined into ``StreamResult.failures`` (and ``failures_path``
    when given) with sanitized rows feeding the win-count reduction.
    ``device=None`` runs on the card and raises without CUDA;
    ``shard=True`` raises ``NotImplementedError`` (the multi-GPU split is
    not ported).
    """
    if shard:
        raise NotImplementedError(xdes._SHARD_LATER)
    device = xdes.resolve_device(device)
    cols = configs if isinstance(configs, dict) else \
        P.config_columns(configs)
    arrs = P.encode_columns(cols, validate=isinstance(configs, dict),
                            strict=strict)
    C = arrs["policy"].shape[0]
    open_loop = bool((np.asarray(arrs["arrival"]) != P.AR_CLOSED).any())
    if reduce is not None:
        if C % reduce.group:
            raise ValueError(f"C={C} not a multiple of reduce.group="
                             f"{reduce.group}")
        if reduce.cell_ids.shape != (C // reduce.group,):
            raise ValueError("cell_ids must have one entry per group")

    auto_dt, steps_arr = xdes.plan_schedule_columns(cols, target_cs)
    dt = auto_dt if dt is None else np.broadcast_to(
        np.asarray(dt, np.float32), (C,)).copy()
    if n_steps is None:
        if int(steps_arr.max()) > xdes.MAX_STEPS and not bucket_steps:
            over = int((steps_arr > xdes.MAX_STEPS).sum())
            warnings.warn(
                f"step cap {xdes.MAX_STEPS} truncates {over}/{C} configs "
                f"below target_cs={target_cs} (see plan_schedule); "
                f"bucket_steps=True keeps fast cells fully sampled.",
                stacklevel=2)
        n_steps = min(int(steps_arr.max()), xdes.MAX_STEPS)
        if early_exit is None:
            early_exit = True
    elif early_exit is None:
        early_exit = False
    arrs["dt"] = np.asarray(dt, np.float32)

    T = max_threads or int(arrs["threads"].max())
    if T < int(arrs["threads"].max()):
        raise ValueError("max_threads smaller than widest config")
    if block_steps is None:
        block_steps = xdes.DEFAULT_BLOCK_STEPS
    tc = int(target_cs) if early_exit else 0

    group = reduce.group if reduce is not None else 1
    quantum = group
    if chunk is None:
        chunk = plan_chunks(C, T, mem_mb=mem_mb, quantum=quantum,
                            open_loop=open_loop, device=device)
    elif chunk % quantum:
        raise ValueError(f"chunk={chunk} not a multiple of the "
                         f"group quantum {quantum}")
    bpc = bytes_per_config(T, open_loop=open_loop)
    budget_mb = memory_budget_bytes(mem_mb, device) / 2**20

    out = {f: np.empty(C, np.float32 if f in ("spin_cpu", "t_end")
                       else np.int32) for f in SUMMARY_FIELDS}
    if open_loop:
        for f in OPEN_SUMMARY_FIELDS:
            out[f] = np.empty(C, np.int32 if f in _OPEN_INT_FIELDS
                              else np.float32)
        out["lat_hist"] = np.empty((C, P.LAT_NBINS), np.int32)
    new_wins = lambda: torch.zeros((reduce.n_cells, group),
                                   dtype=torch.int32, device=device)
    wins = new_wins() if reduce is not None else None
    # Per-chunk cell accumulation needs every group's rows in one call:
    # that holds in row order, but bucketing regroups rows by horizon —
    # there the accumulator folds once at the end instead.
    chunk_reduce = reduce is not None and not bucket_steps
    as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if bucket_steps:
        buckets = xdes.plan_buckets(steps_arr)
        plans = [(idx, min(int(steps_arr[idx].max()), xdes.MAX_STEPS))
                 for idx in buckets]
    else:
        plans = [(None, int(n_steps))]

    # deterministic flat chunk schedule: the unit of checkpoint/resume
    chunk_plans = []
    for idx, horizon in plans:
        rows = C if idx is None else len(idx)
        for lo in range(0, rows, chunk):
            hi = min(lo + chunk, rows)
            chunk_plans.append((idx, lo, hi, horizon))

    failures: list = []
    mgr = None
    cursor = 0                     # chunks already committed (checkpoint)
    if checkpoint_dir is not None:
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(checkpoint_dir, keep_last=2,
                                async_save=False)
        fp = _plan_fingerprint(
            arrs, chunk=chunk, T=T, n_steps=int(n_steps),
            target_cs=tc, backend=backend, bucket_steps=bucket_steps,
            shard=False, group=group)
        template = {"out": {k: np.zeros_like(v) for k, v in out.items()},
                    "wins": (np.zeros((reduce.n_cells, group), np.int32)
                             if reduce is not None
                             else np.zeros((1,), np.int32)),
                    "cursor": np.zeros((), np.int64),
                    "fingerprint": np.zeros_like(fp),
                    "failures_json": np.zeros((), np.uint32)}
        if resume:
            step, tree = mgr.restore(template)
            if tree is not None:
                if not np.array_equal(np.asarray(tree["fingerprint"]), fp):
                    raise ValueError(
                        f"checkpoint in {checkpoint_dir!r} was written by "
                        f"a different sweep plan; refusing to resume")
                cursor = int(tree["cursor"])
                for k in out:
                    out[k][...] = np.asarray(tree["out"][k])
                if reduce is not None:
                    wins = as_dev(tree["wins"])
                nfail = int(tree["failures_json"])
                if nfail and failures_path and os.path.exists(
                        failures_path):
                    with open(failures_path) as f:
                        failures = json.load(f)["failures"][:nfail]
                if verbose:
                    print(f"  stream resume: {cursor}/{len(chunk_plans)} "
                          f"chunks restored from {checkpoint_dir}")

    n_chunks = 0
    run_steps = 0
    for ci, (idx, lo, hi, horizon) in enumerate(chunk_plans):
        n_chunks += 1
        run_steps = max(run_steps, horizon)
        if ci < cursor:
            continue               # committed before the crash: restored
        sel = slice(lo, hi) if idx is None else idx[lo:hi]
        gidx = np.arange(lo, hi) if idx is None else np.asarray(idx[lo:hi])
        part = {k: v[sel] for k, v in arrs.items()}
        n = hi - lo
        res = _run_chunk_resilient(part, horizon, T, backend,
                                   int(block_steps), tc, open_loop, group,
                                   device, verbose)
        for f in SUMMARY_FIELDS:
            out[f][sel] = res[f]
        if open_loop:
            for f in OPEN_SUMMARY_FIELDS:
                out[f][sel] = res[f]
            out["lat_hist"][sel] = res["lat_hist"]
        bad = _quarantine(res, cols, gidx, failures)
        if chunk_reduce:
            completed = np.where(bad, 0, res["completed"]).astype(np.int32)
            t_end = np.where(bad, 1.0, res["t_end"]).astype(np.float32)
            cid = reduce.cell_ids[lo // group:hi // group]
            _cell_update(wins, as_dev(completed), as_dev(t_end),
                         as_dev(cid), group=group)
        if verbose:
            print(f"  stream chunk {ci + 1}/{len(chunk_plans)}: {n} "
                  f"configs x {horizon} steps"
                  + (f" [{int(bad.sum())} quarantined]" if bad.any()
                     else ""))
        if mgr is not None:
            if failures and failures_path:
                _write_failures(failures_path, C, failures)
            mgr.save(ci + 1, {
                "out": out,
                "wins": (wins.cpu().numpy() if wins is not None
                         else np.zeros((1,), np.int32)),
                "cursor": np.int64(ci + 1),
                "fingerprint": fp,
                "failures_json": np.uint32(len(failures))})
    if reduce is not None and not chunk_reduce:
        badf = np.zeros(C, bool)
        for f in _FINITE_FIELDS:
            if f in out:
                badf |= ~np.isfinite(np.asarray(out[f], np.float64))
        wins = _cell_update(
            new_wins(),
            as_dev(np.where(badf, 0, out["completed"]).astype(np.int32)),
            as_dev(np.where(badf, 1.0, out["t_end"]).astype(np.float32)),
            as_dev(reduce.cell_ids), group=group)

    if failures and failures_path:
        _write_failures(failures_path, C, failures)
    if failures:
        warnings.warn(
            f"sweep quarantined {len(failures)}/{C} configs with "
            f"non-finite summaries"
            + (f" (report: {failures_path})" if failures_path else "")
            + "; their rows kept raw values but were excluded from the "
            f"win-count reduction", stacklevel=2)

    return StreamResult(
        n_configs=C, n_steps=run_steps, backend=backend,
        dt=np.asarray(dt, np.float32), t_end=out["t_end"],
        completed=out["completed"], spin_cpu=out["spin_cpu"],
        wake_count=out["wake_count"], final_sws=out["final_sws"],
        steps_run=out["steps_run"], fairness=out["fairness"],
        chunk_size=int(chunk), n_chunks=n_chunks,
        budget_mb=float(budget_mb), bytes_per_config=bpc,
        wins=None if wins is None else wins.cpu().numpy(),
        failures=failures, resumed_chunks=min(cursor, len(chunk_plans)),
        lat_hist=out.get("lat_hist"), arrived=out.get("arrived"),
        shed=out.get("shed"), departed=out.get("departed"),
        slo_viol=out.get("slo_viol"), lat_sum=out.get("lat_sum"),
        occ_int=out.get("occ_int"), in_flight=out.get("in_flight"))
