"""The paper's FL benchmark models (Table III), functional PyTorch.

* ``femnist_cnn``      — the LEAF CNN at its published width: conv5x5(32)
  -> pool -> conv5x5(64) -> pool -> fc(3136 -> 2048) -> fc(2048 -> 62),
  6,603,710 f32 parameters.
* ``shakespeare_lstm`` — the LEAF char LM: embed(8) -> 2 x LSTM(256) ->
  fc(vocab 80), next-token loss (``is_sequence=True``).
* ``cifar_resnet18``   — ResNet-18, CIFAR variant (3x3 stem, no max pool)
  with GroupNorm(8) in place of BatchNorm, 11.2 M parameters.
* ``linear``           — a logistic model for fast tests.

A model is a params dict plus a pure ``apply(params, x) -> logits``, so
``torch.func.vmap`` / ``grad`` batch a cohort of clients the way
``jax.vmap`` does in the reference.  Parameters keep the reference's
layouts — conv weights HWIO, activations NHWC at the boundaries — so the
same numpy arrays load into both packages.  ``apply`` converts to PyTorch's
NCHW/OIHW around each convolution and back to NHWC before the flatten
that feeds ``fc1`` (the reference flattens (h, w, c); an NCHW flatten would
silently scramble ``fc1``).

Convolutions pad as XLA's ``"SAME"`` does: ``pad_total = max((out - 1) *
stride + k - in, 0)`` with the smaller half first, so a 3x3 stride-2 conv
on an even size pads (0, 1) — PyTorch's symmetric ``padding=1`` would
shift every output by one pixel.  GroupNorm takes the mean and population
variance of each group over (H, W, C/g) in f32, as the reference does.

The LSTM is the reference's step loop — ``z = x_t @ wx + h @ wh + b``
split into i, f, g, o, the forget gate biased by +1, zero initial state —
not cuDNN's fused LSTM, whose gate order and bias differ.  Transformer LMs
live in ``models/llm``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    ParamDef, init_params, normal_init, ones_init, zeros_init,
)


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


def _same_pads(size: int, k: int, stride: int):
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(x, w, b, stride: int = 1):
    """NCHW activations, HWIO weight, "SAME" padding as XLA computes it."""
    k = w.shape[0]
    (hl, hh), (wl, wh) = (_same_pads(x.shape[2], k, stride),
                          _same_pads(x.shape[3], k, stride))
    if hl == hh and wl == wh:
        return F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=stride,
                        padding=(hl, wl))
    x = F.pad(x, (wl, wh, hl, hh))     # asymmetric: pad, then a VALID conv
    return F.conv2d(x, w.permute(3, 2, 0, 1), b, stride=stride)


def _groupnorm(x, scale, bias, groups=8, eps=1e-5):
    """GroupNorm of NCHW ``x``: channel c is in group c // (C / g), the
    mean and population variance over (C/g, H, W) in f32."""
    B, C, H, W = x.shape
    g = min(groups, C)
    xg = x.reshape(B, g, C // g, H, W).to(torch.float32)
    mu = xg.mean(dim=(2, 3, 4), keepdim=True)
    var = (xg - mu).square().mean(dim=(2, 3, 4), keepdim=True)
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(B, C, H, W) * scale.view(1, C, 1, 1)
            + bias.view(1, C, 1, 1)).to(x.dtype)


def _gn_def(c):
    return {"scale": ParamDef((c,), init=ones_init),
            "bias": ParamDef((c,), init=zeros_init)}


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


# ---------------------------------------------------------------------------
# Shakespeare LSTM (LEAF reference: embed(8) -> 2xLSTM(256) -> fc(vocab))
# ---------------------------------------------------------------------------

SHAKESPEARE_VOCAB = 80


def _lstm_def(din, dh):
    return {
        "wx": ParamDef((din, 4 * dh)),
        "wh": ParamDef((dh, 4 * dh)),
        "b": ParamDef((4 * dh,), init=zeros_init),
    }


def _lstm(p, x, h, c):
    """(B, S, din) -> (B, S, dh): the reference's cell, one step at a time
    over the sequence axis.  ``x @ wx`` of every step is one product ahead
    of the loop; each step adds ``h @ wh`` and ``b`` in the reference's
    order."""
    xw = (x @ p["wx"]).transpose(0, 1)            # (S, B, 4 dh)
    ys = []
    for t in range(xw.shape[0]):
        z = xw[t] + h @ p["wh"] + p["b"]
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1)


def shakespeare_lstm(vocab: int = SHAKESPEARE_VOCAB, embed: int = 8,
                     hidden: int = 256) -> FLModel:
    defs = {
        "embed": ParamDef((vocab, embed), init=normal_init(0.1)),
        "lstm1": _lstm_def(embed, hidden),
        "lstm2": _lstm_def(hidden, hidden),
        "fc": _fc_def(hidden, vocab),
    }

    def apply(p, x):
        e = p["embed"][x]
        h0 = torch.zeros((x.shape[0], hidden), dtype=e.dtype, device=e.device)
        y = _lstm(p["lstm1"], e, h0, h0)
        y = _lstm(p["lstm2"], y, h0, h0)
        return _fc(y, p["fc"])

    return FLModel("shakespeare_lstm", defs, apply, vocab, (80,),
                   is_sequence=True)


# ---------------------------------------------------------------------------
# ResNet-18 (CIFAR variant, GroupNorm)
# ---------------------------------------------------------------------------


def _block_def(cin, cout, stride):
    d = {
        "conv1": _conv_def(3, cin, cout),
        "gn1": _gn_def(cout),
        "conv2": _conv_def(3, cout, cout),
        "gn2": _gn_def(cout),
    }
    if stride != 1 or cin != cout:
        d["down"] = _conv_def(1, cin, cout)
        d["down_gn"] = _gn_def(cout)
    return d


def _block(p, x, stride):
    y = _conv_same(x, p["conv1"]["w"], p["conv1"]["b"], stride)
    y = F.relu(_groupnorm(y, p["gn1"]["scale"], p["gn1"]["bias"]))
    y = _conv_same(y, p["conv2"]["w"], p["conv2"]["b"])
    y = _groupnorm(y, p["gn2"]["scale"], p["gn2"]["bias"])
    if "down" in p:
        x = _conv_same(x, p["down"]["w"], p["down"]["b"], stride)
        x = _groupnorm(x, p["down_gn"]["scale"], p["down_gn"]["bias"])
    return F.relu(x + y)


def cifar_resnet18(num_classes: int = 10) -> FLModel:
    widths = [64, 128, 256, 512]
    defs: Dict[str, Any] = {
        "stem": _conv_def(3, 3, 64),
        "stem_gn": _gn_def(64),
        "fc": _fc_def(512, num_classes),
    }
    strides = {}
    cin = 64
    for si, w in enumerate(widths):
        for bi in range(2):
            stride = 2 if (si > 0 and bi == 0) else 1
            defs[f"b{si}{bi}"] = _block_def(cin, w, stride)
            strides[f"b{si}{bi}"] = stride
            cin = w

    def apply(p, x):
        x = x.reshape(x.shape[0], 32, 32, 3).permute(0, 3, 1, 2)   # NCHW
        x = _conv_same(x, p["stem"]["w"], p["stem"]["b"])
        x = F.relu(_groupnorm(x, p["stem_gn"]["scale"],
                              p["stem_gn"]["bias"]))
        for si in range(4):
            for bi in range(2):
                x = _block(p[f"b{si}{bi}"], x, strides[f"b{si}{bi}"])
        return _fc(x.mean(dim=(2, 3)), p["fc"])   # global mean pool

    return FLModel("cifar_resnet18", defs, apply, num_classes, (32, 32, 3))


# small logistic model for fast unit tests
def linear_model(din: int = 64, classes: int = 10) -> FLModel:
    defs = {"fc": _fc_def(din, classes)}

    def apply(p, x):
        return _fc(x.reshape(x.shape[0], -1), p["fc"])

    return FLModel("linear", defs, apply, classes, (din,))
