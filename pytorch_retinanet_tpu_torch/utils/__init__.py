"""Training telemetry of the port."""

from .metrics import MetricLogger, SmoothedValue

__all__ = ["MetricLogger", "SmoothedValue"]
