"""The paper's FL benchmark models (Table III), functional PyTorch.

* ``femnist_cnn`` — the LEAF CNN at its published width: conv5x5(32) ->
  pool -> conv5x5(64) -> pool -> fc(3136 -> 2048) -> fc(2048 -> 62),
  6,603,710 f32 parameters.
* ``linear``      — a logistic model for fast tests.

A model is a params dict plus a pure ``apply(params, x) -> logits``, so
``torch.func.vmap`` / ``grad`` batch a cohort of clients the way
``jax.vmap`` does in the reference.  Parameters keep the reference's
layouts — conv weights HWIO, activations NHWC at the boundaries — so the
same numpy arrays load into both packages.  ``apply`` converts to PyTorch's
NCHW/OIHW around each convolution and back to NHWC before the flatten
that feeds ``fc1`` (the reference flattens (h, w, c); an NCHW flatten would
silently scramble ``fc1``).

``shakespeare_lstm`` and ``cifar_resnet18`` are not ported yet
(ROADMAP M3).  Transformer LMs (``is_sequence=True``: next-token loss) live
in ``models/llm``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamDef, init_params, zeros_init


@dataclass(frozen=True, eq=False)  # identity hash: program-cache key
class FLModel:
    name: str
    defs: Any
    apply: Callable  # (params, x) -> logits
    num_classes: int
    input_shape: Tuple[int, ...]
    is_sequence: bool = False

    def init(self, gen: torch.Generator,
             device: Optional[torch.device] = None):
        return init_params(self.defs, gen, device)

    def loss_and_metrics(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        x, y = batch["x"], batch["y"]
        logits = self.apply(params, x)
        if self.is_sequence:
            # language model: predict the next token at every position
            logits = logits[:, :-1]
            y = x[:, 1:]
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, y.long()[..., None])[..., 0]
        acc = (logits.argmax(dim=-1) == y).to(torch.float32).mean()
        return nll.mean(), {"loss": nll.mean(), "accuracy": acc}


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _conv_def(k, cin, cout):
    def he(gen, shape, dtype):
        fan_in = shape[0] * shape[1] * shape[2]
        return (torch.randn(shape, generator=gen)
                * (2.0 / fan_in) ** 0.5).to(dtype)
    return {
        "w": ParamDef((k, k, cin, cout), init=he),
        "b": ParamDef((cout,), init=zeros_init),
    }


def _conv_same(x, w, b):
    """NCHW activations, HWIO weight, stride 1, "SAME" padding (odd k)."""
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, padding=w.shape[0] // 2)


def _fc_def(din, dout):
    return {"w": ParamDef((din, dout)),
            "b": ParamDef((dout,), init=zeros_init)}


def _fc(x, p):
    return x @ p["w"] + p["b"]


# ---------------------------------------------------------------------------
# FEMNIST CNN (LEAF reference: conv5x5(32) -> pool -> conv5x5(64) -> pool
#              -> fc(2048) -> fc(62))
# ---------------------------------------------------------------------------


def femnist_cnn() -> FLModel:
    defs = {
        "conv1": _conv_def(5, 1, 32),
        "conv2": _conv_def(5, 32, 64),
        "fc1": _fc_def(7 * 7 * 64, 2048),
        "fc2": _fc_def(2048, 62),
    }

    def apply(p, x):
        x = x.reshape(x.shape[0], 28, 28, 1).permute(0, 3, 1, 2)   # NCHW
        x = F.relu(_conv_same(x, p["conv1"]["w"], p["conv1"]["b"]))
        x = F.max_pool2d(x, 2, 2)
        x = F.relu(_conv_same(x, p["conv2"]["w"], p["conv2"]["b"]))
        x = F.max_pool2d(x, 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (h, w, c) flatten
        x = F.relu(_fc(x, p["fc1"]))
        return _fc(x, p["fc2"])

    return FLModel("femnist_cnn", defs, apply, 62, (28, 28, 1))


# small logistic model for fast unit tests
def linear_model(din: int = 64, classes: int = 10) -> FLModel:
    defs = {"fc": _fc_def(din, classes)}

    def apply(p, x):
        return _fc(x.reshape(x.shape[0], -1), p["fc"])

    return FLModel("linear", defs, apply, classes, (din,))
