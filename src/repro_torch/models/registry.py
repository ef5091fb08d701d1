"""Model registry backing the ``register_model`` API (paper Table II):
the reference's built-in names, ``resnet18`` an alias of
``cifar_resnet18``."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.models.llm import tiny_lm
from repro_torch.models.small import (
    FLModel, cifar_resnet18, femnist_cnn, linear_model, shakespeare_lstm,
)

_FACTORIES: Dict[str, Callable[[], FLModel]] = {
    "femnist_cnn": femnist_cnn,
    "shakespeare_lstm": shakespeare_lstm,
    "cifar_resnet18": cifar_resnet18,
    "resnet18": cifar_resnet18,
    "linear": linear_model,
    "tiny_lm": tiny_lm,
}

# sensible default model per built-in dataset (init({"model": ...}) optional)
DATASET_DEFAULT_MODEL = {
    "femnist": "femnist_cnn",
    "shakespeare": "shakespeare_lstm",
    "cifar10": "cifar_resnet18",
    "synthetic": "linear",
    "tiny_lm": "tiny_lm",
}


def register_model(name_or_model, model=None) -> None:
    """``register_model(model)`` or ``register_model(name, model)``.

    Accepts an :class:`FLModel` instance or a zero-arg factory.
    """
    if model is None:
        model = name_or_model
        name = getattr(model, "name", None) or model().name
    else:
        name = name_or_model
    if isinstance(model, FLModel):
        _FACTORIES[name] = lambda m=model: m
    else:
        _FACTORIES[name] = model


def get_model(name: str) -> FLModel:
    if name not in _FACTORIES:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(_FACTORIES)}")
    return _FACTORIES[name]()


def list_models():
    return sorted(_FACTORIES)
