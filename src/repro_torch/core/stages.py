"""Training-flow abstraction (paper §V-B, Fig. 3).

A federated round is decomposed into granular, individually overridable
stages.  Server:   selection -> compression -> distribution -> aggregation
Client:  download -> decompression -> train/test -> compression ->
         encryption -> upload.

Subclass :class:`repro_torch.core.client.Client` or
:class:`repro_torch.core.server.Server` and replace only the stages an
algorithm changes; the sequential engine runs every override.  This module
holds the stage names (for tracking) and the default pass-through hook.
"""
from __future__ import annotations

SERVER_STAGES = ("selection", "compression", "distribution", "aggregation")
CLIENT_STAGES = ("download", "decompression", "train", "test",
                 "compression", "encryption", "upload")


def identity_stage(payload):
    """Default pass-through used by optional stages (e.g. encryption)."""
    return payload
