"""paddle_tpu_torch.monitor: the part of `paddle_tpu.monitor` that
serving reads. `flight` (the event ring, in-flight spans and incident
hooks), `trace` (per-request timelines and their spool) and `alerts`
(the SLO rule engine the serving `Autoscaler` listens to). The rest of
the JAX package's monitor planes (chaos, the watchdog and its dump
bundles, the debug server, the sanitizer, perf and memory ledgers, the
CLI) are ROADMAP queue 1 item 4."""
from __future__ import annotations

from . import alerts, flight, trace

__all__ = ["alerts", "flight", "trace"]
