"""Declarative multi-process launcher — the local DynamoGraphDeployment
(port of `dynamo_tpu/launcher/`).

Role of the reference's K8s operator (`deploy/cloud/operator`, CRDs at
`api/v1alpha1/dynamographdeployment_types.go:58`, graph → per-component
deployments in `internal/dynamo/graph.go:145`) scoped to one host: a
graph TOML declares the services (frontend / workers / planner / …),
their replica counts and restart policies; the launcher spawns them as
OS processes with the control-plane address injected, supervises them
(restart with backoff per policy), and tears the graph down in reverse
order on SIGTERM.

    [graph]
    namespace = "dynamo"
    serve_control_plane = true        # host the control plane in-process
    control_plane = "127.0.0.1:0"     # or point at an external one

    [services.frontend]
    module = "dynamo_tpu_torch.frontend"
    args = ["--http-port", "8000", "--router-mode", "kv"]

    [services.decode]
    module = "dynamo_tpu_torch.worker"
    args = ["--model", "llama-3-1b", "--model-name", "m"]
    replicas = 2
    restart = "always"                # always | on-failure | never

A standalone control plane is a service too: `serve_control_plane =
false`, `control_plane = "127.0.0.1:PORT"`, and a service
`dynamo_tpu_torch.control_plane_service` with `args = ["--port", "PORT",
"--store", "file:PATH"]` and `inject_control_plane = false`.

Usage: `python -m dynamo_tpu_torch.launcher graph.toml`.
"""

from dynamo_tpu_torch.launcher.launcher import (
    GraphSpec,
    Launcher,
    ServiceSpec,
    load_graph,
)

__all__ = ["GraphSpec", "ServiceSpec", "Launcher", "load_graph"]
