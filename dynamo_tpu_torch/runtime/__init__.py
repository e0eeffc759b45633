"""Distributed runtime (port of `dynamo_tpu/runtime/`).

The control plane (leases, watches, pub/sub, work queues; in process or
over TCP), the streaming RPC between processes with its own wire codec,
the Namespace → Component → Endpoint → Client model, layered config, the
operator pipeline and the per-process status server; and the
observability plane: Prometheus metrics and the engine's step counters
(`metrics`), distributed tracing (`tracing`), the flight recorder and
stall watchdog (`flight_recorder`), the request ledger (`ledger`), the
SLO burn-rate monitor (`slo`), the device profiler (`device_profiler`)
and the thread-affinity contracts (`contracts`).  Standard library only
(torch inside the device profiler's capture): the GPU machine has no
msgpack, no aiohttp and no prometheus_client.
"""
