"""Distributed runtime: heartbeats, straggler/failure detection, elastic
re-meshing, and the hot-spare spinning window."""

from .elastic import ElasticMesh, HotSparePool, MeshPlan, SpareStats
from .heartbeat import HeartbeatBoard, MonitorReport, StragglerMonitor

__all__ = ["HeartbeatBoard", "StragglerMonitor", "MonitorReport",
           "ElasticMesh", "MeshPlan", "HotSparePool", "SpareStats"]
