from repro_torch.deploy.discovery import Registor, Registration, Registry  # noqa: F401
from repro_torch.deploy.manifests import (  # noqa: F401
    compose, dockerfile, k8s_manifests, write_artifacts,
)
