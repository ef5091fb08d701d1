from repro_torch.data.fed_data import (  # noqa: F401
    ClientData, FederatedDataset, build_federated_data, register_dataset,
)
from repro_torch.data.partition import partition  # noqa: F401
from repro_torch.data.synthetic import RawDataset, make_dataset  # noqa: F401
