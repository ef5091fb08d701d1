"""Deployment artifact generation (paper §VII: containerization).

Generates the Dockerfile, docker-compose stack and Kubernetes manifests
that deploy a server, N clients, a registry and a tracker of the port on
NVIDIA GPUs: one image, four roles, entry point
``python -m repro_torch.launch.service``.  The image starts from a CUDA
*devel* base, because the kernels are compiled with ``nvcc`` at first use
(``repro_torch.kernels.build``) into a directory the container can write;
it copies only the port's sources and sets ``PYTHONPATH``.  The server and
client services request one GPU each; registry and tracker are host-only.

``yaml`` is imported by :func:`write_artifacts` alone, so the rest of the
module (and ``import repro_torch.deploy``) needs no PyYAML.
"""
from __future__ import annotations

import os
from typing import Dict, List

IMAGE = "easyfl-repro-torch:latest"

DOCKERFILE = """\
FROM pytorch/pytorch:2.5.1-cuda12.4-cudnn9-devel
WORKDIR /app
COPY src/repro_torch ./src/repro_torch
ENV PYTHONPATH=/app/src \\
    REPRO_TORCH_BUILD_DIR=/tmp/repro_torch_kernels
# role selected at runtime: server | client | registry | tracker
ENTRYPOINT ["python", "-m", "repro_torch.launch.service"]
"""

#: compose's request for one NVIDIA GPU
_COMPOSE_GPU = {"resources": {"reservations": {"devices": [
    {"driver": "nvidia", "count": 1, "capabilities": ["gpu"]}]}}}


def dockerfile() -> str:
    return DOCKERFILE


def compose(num_clients: int = 2, image: str = IMAGE,
            network_latency_ms: int = 0) -> Dict:
    """docker-compose stack with an etcd-style registry + netem latency."""
    services = {
        "registry": {
            "image": image,
            "command": ["registry", "--port", "2379"],
            "networks": ["flnet"],
        },
        "tracker": {
            "image": image,
            "command": ["tracker", "--port", "9000"],
            "networks": ["flnet"],
        },
        "server": {
            "image": image,
            "command": ["server", "--registry", "registry:2379",
                        "--tracker", "tracker:9000"],
            "depends_on": ["registry", "tracker"],
            "networks": ["flnet"],
            "deploy": _COMPOSE_GPU,
        },
    }
    for i in range(num_clients):
        svc = {
            "image": image,
            "command": ["client", "--registry", "registry:2379",
                        "--client-id", f"client_{i:04d}"],
            "depends_on": ["server"],
            "networks": ["flnet"],
            "deploy": _COMPOSE_GPU,
        }
        if network_latency_ms:
            # system-heterogeneity simulation via container network config
            svc["cap_add"] = ["NET_ADMIN"]
            svc["command"] += ["--netem-latency-ms", str(network_latency_ms)]
        services[f"client{i}"] = svc
    return {"services": services, "networks": {"flnet": {}}}


def k8s_manifests(num_clients: int = 2, image: str = IMAGE) -> List[Dict]:
    """Kubernetes stack: Service = registry (DNS), Pods register via the
    downward API (the Pod itself acts as registor, §VIII-A); server and
    client Pods each limit ``nvidia.com/gpu`` to 1."""
    gpu = {"limits": {"nvidia.com/gpu": 1}}
    out: List[Dict] = []
    out.append({
        "apiVersion": "v1", "kind": "Service",
        "metadata": {"name": "easyfl-server"},
        "spec": {"selector": {"app": "easyfl-server"},
                 "ports": [{"port": 8000, "targetPort": 8000}]},
    })
    out.append({
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "easyfl-server"},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": {"app": "easyfl-server"}},
            "template": {
                "metadata": {"labels": {"app": "easyfl-server"}},
                "spec": {"containers": [{
                    "name": "server", "image": image,
                    "args": ["server"],
                    "ports": [{"containerPort": 8000}],
                    "resources": gpu,
                }]},
            },
        },
    })
    out.append({
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "easyfl-client"},
        "spec": {
            "replicas": num_clients,
            "selector": {"matchLabels": {"app": "easyfl-client"}},
            "template": {
                "metadata": {"labels": {"app": "easyfl-client"}},
                "spec": {"containers": [{
                    "name": "client", "image": image,
                    "args": ["client", "--server", "easyfl-server:8000"],
                    "env": [
                        # downward API: the Pod learns its own address and
                        # self-registers — the registor role from Fig. 4b
                        {"name": "POD_IP", "valueFrom": {
                            "fieldRef": {"fieldPath": "status.podIP"}}},
                        {"name": "POD_NAME", "valueFrom": {
                            "fieldRef": {"fieldPath": "metadata.name"}}},
                    ],
                    "resources": gpu,
                }]},
            },
        },
    })
    return out


def write_artifacts(out_dir: str, num_clients: int = 2) -> List[str]:
    """Write ``Dockerfile``, ``docker-compose.yaml`` and ``k8s.yaml`` into
    ``out_dir`` (needs PyYAML) -> their paths."""
    import yaml

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    p = os.path.join(out_dir, "Dockerfile")
    with open(p, "w") as f:
        f.write(dockerfile())
    paths.append(p)
    p = os.path.join(out_dir, "docker-compose.yaml")
    with open(p, "w") as f:
        yaml.safe_dump(compose(num_clients), f, sort_keys=False)
    paths.append(p)
    p = os.path.join(out_dir, "k8s.yaml")
    with open(p, "w") as f:
        yaml.safe_dump_all(k8s_manifests(num_clients), f, sort_keys=False)
    paths.append(p)
    return paths
