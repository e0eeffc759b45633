"""Distributed runtime (port of `dynamo_tpu/runtime/`, the serving core).

The control plane (leases, watches, pub/sub, work queues; in process or
over TCP), the streaming RPC between processes with its own wire codec,
the Namespace → Component → Endpoint → Client model, layered config, the
operator pipeline and the worker's status server.  Standard library only:
the GPU machine has no msgpack and no aiohttp.
"""
