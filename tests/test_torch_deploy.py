"""The port's K8s manifest renderer (`dynamo_tpu_torch.deploy`) against the
JAX package's, on the CPU.

The same graph TOMLs (the repo's disagg example and a port graph of
`dynamo_tpu_torch.*` services with replicas, a planner and an unmanaged
control plane) render, through each package's launcher parser, to the
same manifests except for what the port changes on purpose: the modules
run are the port's, a worker asks for `nvidia.com/gpu` where JAX asks for
`google.com/tpu`, and no `JAX_PLATFORMS` is set.  Every file is valid
YAML; a worker group of several processes is refused; the CLI writes
the files.

Tolerance: none; the manifests are compared as parsed documents.
"""

import os

import pytest
import yaml

from dynamo_tpu import deploy as jdeploy
from dynamo_tpu.launcher.launcher import load_graph as jload
from dynamo_tpu_torch import deploy as tdeploy
from dynamo_tpu_torch.launcher.launcher import GraphSpec, ServiceSpec
from dynamo_tpu_torch.launcher.launcher import load_graph as tload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(REPO, "examples", "disagg_graph.toml")

PORT_GRAPH = """
namespace = "gpu"
control_plane = "127.0.0.1:7411"

[services.frontend]
module = "dynamo_tpu_torch.frontend"
args = ["--router-mode", "kv", "--http-port", "8001"]

[services.worker]
module = "dynamo_tpu_torch.worker"
replicas = 3
args = ["--model", "llama-3-1b", "--model-name", "m"]

[services.planner]
module = "dynamo_tpu_torch.planner"
args = ["--min-replicas", "1"]
inject_control_plane = false
"""


def _normalize(docs, jax_side):
    """Drop what the port changes on purpose: module prefixes, device
    resources and the JAX platform variable."""
    out = []
    for doc in docs:
        doc = yaml.safe_load(yaml.safe_dump(doc))
        spec = doc.get("spec", {})
        for c in spec.get("template", {}).get("spec", {}).get(
                "containers", []):
            c["command"] = [a.replace("dynamo_tpu_torch.", "dynamo_tpu.")
                            for a in c["command"]]
            c.pop("resources", None)
            c["env"] = [e for e in c["env"] if e["name"] != "JAX_PLATFORMS"]
        out.append(doc)
    return out


def _graphs(tmp_path):
    port = tmp_path / "port_graph.toml"
    port.write_text(PORT_GRAPH)
    return [EXAMPLE, str(port)]


@pytest.mark.parametrize("which", [0, 1])
def test_renders_jax_manifests_but_for_modules_and_devices(tmp_path, which):
    path = _graphs(tmp_path)[which]
    got = tdeploy.render_graph(tload(path), "img:1", gpus_per_worker=2)
    want = jdeploy.render_graph(jload(path), "img:1", tpu_chips_per_worker=2)
    assert _normalize(got, False) == _normalize(want, True)
    workers = 0
    for doc in got:
        for c in doc["spec"].get("template", {}).get("spec", {}).get(
                "containers", []):
            module = c["command"][-1]
            assert module.startswith("dynamo_tpu_torch."), module
            assert all(e["name"] != "JAX_PLATFORMS" for e in c["env"])
            if module.endswith("worker"):
                workers += 1
                assert c["resources"] == {"limits": {"nvidia.com/gpu": "2"}}
            else:
                assert "resources" not in c
    assert workers >= 1


def test_files_are_valid_yaml_and_match_jax(tmp_path):
    for path in _graphs(tmp_path):
        tdir, jdir = tmp_path / "t", tmp_path / "j"
        tfiles = tdeploy.render_to_dir(tload(path), "img:1", str(tdir),
                                       gpus_per_worker=1, graph_toml=path)
        jfiles = jdeploy.render_to_dir(jload(path), "img:1", str(jdir),
                                       tpu_chips_per_worker=1,
                                       graph_toml=path)
        assert ([os.path.basename(f) for f in tfiles]
                == [os.path.basename(f) for f in jfiles])
        tdocs = [yaml.safe_load(open(f)) for f in tfiles]
        jdocs = [yaml.safe_load(open(f)) for f in jfiles]
        assert _normalize(tdocs, False) == _normalize(jdocs, True)
        cm = tdocs[-1]
        assert cm["kind"] == "ConfigMap"
        assert cm["data"]["graph.toml"] == open(path).read()


def test_multiprocess_worker_group_is_refused():
    spec = GraphSpec(namespace="mh", services=[ServiceSpec(
        name="decode", module="dynamo_tpu_torch.worker",
        args=["--model", "llama-3-1b", "--num-processes", "2"])])
    with pytest.raises(ValueError, match="single-process"):
        tdeploy.render_graph(spec, "img:1")


def test_cli_writes_manifests(tmp_path, capsys):
    out = tmp_path / "m"
    tdeploy.main([EXAMPLE, "--image", "img:2", "-o", str(out),
                  "--gpus-per-worker", "1"])
    printed = capsys.readouterr().out.split()
    assert printed and all(os.path.exists(p) for p in printed)
    kinds = [yaml.safe_load(open(p))["kind"] for p in printed]
    assert "PersistentVolumeClaim" in kinds and "ConfigMap" in kinds
    assert kinds.count("Deployment") >= 4
