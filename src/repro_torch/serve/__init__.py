"""Serving: slot-based decode engine + window-driven continuous batching,
and the scheduler-policy sweep through the batched simulator (the port of
``repro.serve``)."""

from .engine import DecodeEngine, Request, SimulatedEngine
from .scheduler import (SCHED_POLICY_LOCKS, ContinuousBatcher, SchedScenario,
                        SchedStats, sample_sched_scenarios, xdes_policy_sweep)

__all__ = ["DecodeEngine", "SimulatedEngine", "Request",
           "ContinuousBatcher", "SchedStats", "SchedScenario",
           "sample_sched_scenarios", "xdes_policy_sweep",
           "SCHED_POLICY_LOCKS"]
