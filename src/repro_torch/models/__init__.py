from repro_torch.models.registry import (  # noqa: F401
    get_model, list_models, register_model,
)
from repro_torch.models.small import FLModel, femnist_cnn, linear_model  # noqa: F401
