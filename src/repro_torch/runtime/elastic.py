"""Elastic scaling: re-mesh + reshard on membership change, and the paper's
spinning window applied to HOT SPARES.

Two pieces:

1. :class:`ElasticMesh` — given the current healthy host set, derives the
   largest usable mesh (shrinking the data/pod axes first, never the model
   axis, so parameter shardings stay compatible); a checkpoint restores
   into the new topology as it is, since its leaves' shapes do not depend
   on the mesh.

2. :class:`HotSparePool` — the mutable-lock insight at cluster scale:
   *hot spares* are standby hosts kept with the framework booted and the
   latest checkpoint pre-staged (spinning: they cost reserved capacity but
   replace a failed host in seconds); *cold spares* must be provisioned +
   restore from scratch (sleeping: free until needed, wake-up latency =
   minutes).  A failure that finds no hot spare is a **late wake-up** →
   the pool target doubles; K consecutive failures absorbed by hot spares →
   shrink by one.  This is `SpinningWindow` verbatim — the oracle never
   changed, only the resource.

The port of ``repro/runtime/elastic.py``: host logic over the port's
``core.oracle`` and ``core.window``.  The plan is arithmetic over hosts
and chips; nothing here builds a device mesh, as in the reference (the
port's meshes are ``repro_torch.launch.mesh``'s).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.core.oracle import EvalSWS, Oracle
from repro_torch.core.window import SpinningWindow


# --------------------------------------------------------------------------
# Re-meshing
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class MeshPlan:
    pod: int
    data: int
    model: int
    hosts_used: int
    hosts_idle: int

    @property
    def shape(self):
        return ((self.pod, self.data, self.model) if self.pod > 1
                else (self.data, self.model))

    @property
    def axis_names(self):
        return (("pod", "data", "model") if self.pod > 1
                else ("data", "model"))


class ElasticMesh:
    """Chooses the mesh for the currently-healthy host set.

    Chips per host is fixed (TPU vm topology); the model axis is preserved
    (changing it would re-partition every weight); the data axis shrinks to
    the largest power-of-two-ish divisor the survivors support.  Training
    keeps the same GLOBAL batch by raising grad-accum, so the loss curve is
    unaffected by elasticity (the standard elastic-DP contract).
    """

    def __init__(self, chips_per_host: int = 4, model_axis: int = 16,
                 global_batch: int = 256):
        self.chips_per_host = chips_per_host
        self.model_axis = model_axis
        self.global_batch = global_batch

    def plan(self, healthy_hosts: int) -> MeshPlan:
        chips = healthy_hosts * self.chips_per_host
        if chips < self.model_axis:
            raise ValueError(
                f"{healthy_hosts} hosts x {self.chips_per_host} chips cannot "
                f"hold the model axis ({self.model_axis})")
        data_max = chips // self.model_axis
        # largest data size that divides the global batch
        data = max(d for d in range(1, data_max + 1)
                   if self.global_batch % d == 0)
        pods = 1
        used = (pods * data * self.model_axis) // self.chips_per_host
        return MeshPlan(pod=pods, data=data, model=self.model_axis,
                        hosts_used=used, hosts_idle=healthy_hosts - used)

    def accum_for(self, plan: MeshPlan, base_accum: int = 1,
                  full_data: int = 16) -> int:
        """Scale grad-accum so tokens-per-optimizer-step stays constant."""
        return max(1, int(base_accum * full_data / plan.data))


# --------------------------------------------------------------------------
# Hot-spare pool (the paper's window over standby capacity)
# --------------------------------------------------------------------------
@dataclass
class SpareStats:
    failures: int = 0
    masked: int = 0              # failure absorbed by a hot spare
    exposed: int = 0             # failure had to cold-provision (late wake)
    recovery_s_total: float = 0.0
    hot_host_seconds: float = 0.0
    window_trace: list = field(default_factory=list)


class HotSparePool:
    """Self-tuned hot-spare target; drive with failure/heal events.

    ``hot_spinup_s`` — promote hot spare -> serving (seconds; checkpoint
    already staged).  ``cold_spinup_s`` — provision + restore (the wake-up
    latency the window exists to mask).
    """

    def __init__(self, max_spares: int, initial: int = 1,
                 oracle: Oracle | None = None, hot_spinup_s: float = 30.0,
                 cold_spinup_s: float = 600.0):
        from repro_torch.core.oracle import FixedOracle
        # a static zero pool (cold-only ablation) must stay at zero; the
        # adaptive oracle keeps the paper's >=1 clamp so doubling can fire
        min_size = 0 if (initial == 0
                         and isinstance(oracle, FixedOracle)) else 1
        self.window = SpinningWindow(max_size=max_spares, initial=initial,
                                     min_size=min_size,
                                     oracle=oracle or EvalSWS(k=10))
        self.hot = initial
        self.cold_queue = 0          # spares warming up towards hot
        self.hot_spinup_s = hot_spinup_s
        self.cold_spinup_s = cold_spinup_s
        self.stats = SpareStats()

    def tick(self, dt_s: float) -> None:
        self.stats.hot_host_seconds += self.hot * dt_s

    def on_failure(self) -> float:
        """A host died.  Returns the recovery latency experienced."""
        self.stats.failures += 1
        if self.hot > 0:
            self.hot -= 1
            latency = self.hot_spinup_s
            self.stats.masked += 1
            late = False
        else:
            latency = self.cold_spinup_s
            self.stats.exposed += 1
            late = True
        self.stats.recovery_s_total += latency
        corr = self.window.observe(late_wake=late,
                                   occupancy=self.hot + self.cold_queue + 1)
        # refill towards the (possibly resized) target
        want = self.window.sws - self.hot - self.cold_queue
        if want > 0:
            self.cold_queue += want
        self.stats.window_trace.append(self.window.sws)
        return latency

    def on_spare_ready(self, n: int = 1) -> None:
        """Cold spares finished warming (call after cold_spinup_s)."""
        take = min(n, self.cold_queue)
        self.cold_queue -= take
        self.hot += take
        # C2: if the window shrank below the hot count, release capacity
        if self.hot > self.window.sws:
            self.hot = self.window.sws
