"""FedProx [Li et al., MLSys'20] as a one-stage plugin (paper Table V).

FedProx changes one thing against FedAvg: the client objective gains a
proximal term mu/2 ||w - w_global||^2.  Under the training-flow abstraction
that is a *train-stage* change; selection, distribution, aggregation and
communication are reused.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.client import Client


class FedProxClient(Client):
    """Train-stage override: inject the proximal term.

    The local step already takes ``proximal_mu`` (it lives inside the
    loss, ``local_train.client_grads``), so the override is configuration
    only.  Because mu lives in the client config it composes with every
    other per-client knob: the batched and async engines stack
    ``proximal_mu`` into the cohort's ``CohortVectors`` beside the
    per-client optimizer hyperparameters, so one program serves a cohort
    of mixed FedProx strengths.  Per-client mu without a custom client
    class: ``system_heterogeneity.hyperparam_choices = {"proximal_mu":
    (0.0, 0.01, 0.1)}``.
    """

    def __init__(self, client_id, model, data, cfg, batch_size=64,
                 mu: float = 0.01):
        if cfg.proximal_mu == 0.0:
            cfg = dataclasses.replace(cfg, proximal_mu=mu)
        super().__init__(client_id, model, data, cfg, batch_size)


def fedprox_config(base: dict | None = None, mu: float = 0.01) -> dict:
    cfg = dict(base or {})
    cfg.setdefault("client", {})["proximal_mu"] = mu
    return cfg
