"""Kubernetes manifest renderer for serving graphs (port of
`dynamo_tpu/deploy/`).

Role of the reference's Go operator (`deploy/cloud/operator`:
`DynamoGraphDeployment` CRD -> per-component Deployments/Services,
`internal/dynamo/graph.go:145` GenerateDynamoComponentsDeployments).
There is no cluster to run a controller against, so the port ships the
operator's generator half as a deterministic renderer: the graph TOML the
port's launcher runs (`dynamo_tpu_torch.launcher.load_graph`) renders to
K8s manifests —

  - one Deployment + Service per graph service (replicas honored), each
    running the port's module (`dynamo_tpu.X` in a graph names
    `dynamo_tpu_torch.X`);
  - a control-plane Deployment + Service with a PVC-backed file store
    (the durable queue/config snapshot, runtime/kv_store.py);
  - workers asking for `--gpus-per-worker N` NVIDIA GPUs
    (`nvidia.com/gpu`);
  - a ConfigMap carrying the graph TOML for reproducibility.

A worker group of several processes (`--num-processes N`, one engine
over N processes: parallel/multihost.py) renders as JAX's: a StatefulSet
of N pods and a headless Service, pod 0's DNS name giving every process
`--coordinator ...:9876` and `--lockstep ...:9877`, the pod's ordinal its
`--process-id`.  `kubectl apply -f` the output directory:

    python -m dynamo_tpu_torch.deploy graph.toml \
        --image ghcr.io/example/dynamo-tpu-torch:latest -o manifests
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
from typing import Dict, List, Optional

CP_PORT = 7411
HTTP_PORT = 8080  # frontend/main.py's default --http-port


def _name(graph_ns: str, svc: str) -> str:
    return f"dynamo-{graph_ns}-{svc}".replace("_", "-").lower()


def _labels(graph_ns: str, svc: str) -> Dict[str, str]:
    return {
        "app.kubernetes.io/name": "dynamo-tpu",
        "app.kubernetes.io/instance": graph_ns,
        "app.kubernetes.io/component": svc,
    }


def _flag_value(args: List[str], flag: str) -> Optional[str]:
    if flag in args:
        i = args.index(flag)
        if i + 1 < len(args):
            return args[i + 1]
    for a in args:
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return None


def _strip_flag(args: List[str], flag: str) -> List[str]:
    """Remove `--flag value` AND `--flag=value` forms."""
    out: List[str] = []
    skip = False
    for a in args:
        if skip:
            skip = False
            continue
        if a == flag:
            skip = True
            continue
        if a.startswith(flag + "="):
            continue
        out.append(a)
    return out


def port_module(module: str) -> str:
    """The port's module for a graph's module name."""
    if module == "dynamo_tpu" or module.startswith("dynamo_tpu."):
        return "dynamo_tpu_torch" + module[len("dynamo_tpu"):]
    return module


def _container(name: str, image: str, module: str, args: List[str],
               gpus: Optional[str], ports: List[dict]) -> dict:
    c = {
        "name": name,
        "image": image,
        "command": ["python", "-m", port_module(module)],
        "args": args,
        "ports": ports,
        # POD_IP via the downward API: kubelet expands $(POD_IP) in
        # args, giving workers a ROUTABLE advertised RPC address
        # (their 127.0.0.1 default only works single-host).
        "env": [
            {"name": "POD_IP",
             "valueFrom": {"fieldRef": {"fieldPath": "status.podIP"}}},
        ],
    }
    if gpus:
        c["resources"] = {"limits": {"nvidia.com/gpu": gpus}}
    return c


def render_graph(spec, image: str,
                 gpus_per_worker: Optional[int] = None) -> List[dict]:
    """GraphSpec -> list of K8s manifest dicts (apply order preserved)."""
    ns = spec.namespace
    out: List[dict] = []
    cp_name = _name(ns, "control-plane")
    cp_addr = f"{cp_name}:{CP_PORT}"

    # Control plane: Deployment (single replica) + Service + PVC store.
    out.append({
        "apiVersion": "v1", "kind": "PersistentVolumeClaim",
        "metadata": {"name": f"{cp_name}-store",
                     "labels": _labels(ns, "control-plane")},
        "spec": {"accessModes": ["ReadWriteOnce"],
                 "resources": {"requests": {"storage": "1Gi"}}},
    })
    out.append({
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": cp_name,
                     "labels": _labels(ns, "control-plane")},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": _labels(ns, "control-plane")},
            "template": {
                "metadata": {"labels": _labels(ns, "control-plane")},
                "spec": {
                    "containers": [_container(
                        "control-plane", image,
                        "dynamo_tpu_torch.control_plane_service",
                        ["--host", "0.0.0.0", "--port", str(CP_PORT),
                         "--store", "file:/var/lib/dynamo/cp.json"],
                        None,
                        [{"containerPort": CP_PORT}])],
                    "volumes": [{
                        "name": "store",
                        "persistentVolumeClaim":
                            {"claimName": f"{cp_name}-store"}}],
                },
            },
        },
    })
    out[-1]["spec"]["template"]["spec"]["containers"][0]["volumeMounts"] \
        = [{"name": "store", "mountPath": "/var/lib/dynamo"}]
    out.append({
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": cp_name,
                     "labels": _labels(ns, "control-plane")},
        "spec": {"selector": _labels(ns, "control-plane"),
                 "ports": [{"port": CP_PORT,
                            "targetPort": CP_PORT}]},
    })

    for svc in spec.services:
        name = _name(ns, svc.name)
        labels = _labels(ns, svc.name)
        args = list(svc.args)
        if svc.inject_control_plane and "--control-plane" not in args:
            args += ["--control-plane", cp_addr]
        is_frontend = svc.module.endswith("frontend")
        is_worker = svc.module.endswith("worker")
        if is_frontend:
            # The app's default binds 127.0.0.1 — unreachable through
            # kube-proxy; bind the pod-wide wildcard.
            if _flag_value(args, "--http-host") is None:
                args += ["--http-host", "0.0.0.0"]
        if is_worker and _flag_value(args, "--rpc-host") is None:
            args += ["--rpc-host", "$(POD_IP)"]
        ports = ([{"containerPort": int(_flag_value(args, "--http-port")
                                        or HTTP_PORT)}]
                 if is_frontend else [])
        n_proc = int(_flag_value(args, "--num-processes") or 1)
        gpus = (str(gpus_per_worker)
                if gpus_per_worker and svc.module.endswith("worker")
                else None)

        if n_proc > 1:
            # A multihost worker group (parallel/multihost.py): a
            # StatefulSet and a headless Service, whose stable DNS gives
            # every process the coordinator and lockstep addresses of
            # pod 0, as JAX's renderer lays it out.
            head = f"{name}-ranks"
            rank0 = f"{name}-0.{head}"
            base = _strip_flag(list(args), "--process-id")
            base += ["--coordinator", f"{rank0}:9876",
                     "--lockstep", f"{rank0}:9877"]
            out.append({
                "apiVersion": "v1", "kind": "Service",
                "metadata": {"name": head, "labels": labels},
                "spec": {"clusterIP": "None", "selector": labels,
                         "ports": [{"port": 9876, "name": "coordinator"},
                                   {"port": 9877, "name": "lockstep"}]},
            })
            module = port_module(svc.module)
            out.append({
                "apiVersion": "apps/v1", "kind": "StatefulSet",
                "metadata": {"name": name, "labels": labels},
                "spec": {
                    "serviceName": head,
                    "replicas": n_proc,
                    "podManagementPolicy": "Parallel",
                    "selector": {"matchLabels": labels},
                    "template": {
                        "metadata": {"labels": labels},
                        "spec": {"containers": [{
                            **_container(svc.name, image, svc.module,
                                         base, gpus, []),
                            # The process id is the pod's ordinal: the
                            # shell expands it (and kubelet $(POD_IP));
                            # every other argument is quoted.
                            "command": ["/bin/sh", "-c"],
                            "args": [
                                "exec python -m " + module + " "
                                + " ".join(
                                    a if a == "$(POD_IP)"
                                    else shlex.quote(a) for a in base)
                                + " --process-id ${HOSTNAME##*-}"],
                        }]},
                    },
                },
            })
            continue

        out.append({
            "apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "labels": labels},
            "spec": {
                "replicas": svc.replicas,
                "selector": {"matchLabels": labels},
                "template": {
                    "metadata": {"labels": labels},
                    "spec": {"containers": [_container(
                        svc.name, image, svc.module, args, gpus, ports)]},
                },
            },
        })
        if is_frontend:
            out.append({
                "apiVersion": "v1", "kind": "Service",
                "metadata": {"name": name, "labels": labels},
                "spec": {"selector": labels,
                         "ports": [{"port": 80,
                                    "targetPort": ports[0][
                                        "containerPort"]}]},
            })
    return out


def _to_yaml(doc: dict, indent: int = 0) -> str:
    """Minimal YAML emitter (no pyyaml dependency): dicts/lists/scalars
    only — exactly the shapes render_graph produces."""
    pad = "  " * indent
    lines: List[str] = []
    if isinstance(doc, dict):
        for k, v in doc.items():
            if isinstance(v, (dict, list)) and v:
                lines.append(f"{pad}{k}:")
                lines.append(_to_yaml(v, indent + 1))
            else:
                lines.append(f"{pad}{k}: {_scalar(v)}")
    elif isinstance(doc, list):
        for item in doc:
            if isinstance(item, (dict, list)) and item:
                body = _to_yaml(item, indent + 1)
                first, _, rest = body.partition("\n")
                lines.append(f"{pad}- {first.strip()}")
                if rest:
                    lines.append(rest)
            else:
                lines.append(f"{pad}- {_scalar(item)}")
    return "\n".join(lines)


def _scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None or v == {} or v == []:
        return "{}" if isinstance(v, dict) else \
            ("[]" if isinstance(v, list) else "null")
    if isinstance(v, (int, float)):
        return str(v)
    return json.dumps(str(v))  # quoted string, JSON-escaped (YAML-safe)


def render_to_dir(spec, image: str, out_dir: str,
                  gpus_per_worker: Optional[int] = None,
                  graph_toml: Optional[str] = None) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    docs = render_graph(spec, image, gpus_per_worker)
    written = []
    for i, doc in enumerate(docs):
        fname = (f"{i:02d}-{doc['kind'].lower()}-"
                 f"{doc['metadata']['name']}.yaml")
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            f.write(_to_yaml(doc) + "\n")
        written.append(path)
    if graph_toml:
        cm = {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": _name(spec.namespace, "graph"),
                         "labels": _labels(spec.namespace, "graph")},
            "data": {"graph.toml": open(graph_toml).read()},
        }
        path = os.path.join(out_dir, "99-configmap-graph.yaml")
        with open(path, "w") as f:
            f.write(_to_yaml(cm) + "\n")
        written.append(path)
    return written


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        "dynamo_tpu_torch.deploy",
        description="Render a serving-graph TOML to K8s manifests "
                    "(the operator's generator half)")
    p.add_argument("graph", help="graph TOML (launcher format)")
    p.add_argument("--image", required=True)
    p.add_argument("-o", "--out", default="./manifests")
    p.add_argument("--gpus-per-worker", type=int, default=None,
                   help="NVIDIA GPUs a worker pod asks for "
                        "(nvidia.com/gpu)")
    args = p.parse_args(argv)

    from dynamo_tpu_torch.launcher.launcher import load_graph

    spec = load_graph(args.graph)
    written = render_to_dir(spec, args.image, args.out,
                            args.gpus_per_worker, args.graph)
    for w in written:
        print(w)
