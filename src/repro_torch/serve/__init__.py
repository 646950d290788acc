"""Serving: slot-based decode engine + window-driven continuous batching
(the port of ``repro.serve``, minus the scheduler-policy sweep)."""

from .engine import DecodeEngine, Request, SimulatedEngine
from .scheduler import ContinuousBatcher, SchedStats

__all__ = ["DecodeEngine", "SimulatedEngine", "Request",
           "ContinuousBatcher", "SchedStats"]
