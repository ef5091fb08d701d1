"""repro_torch — EasyFL (Zhuang et al., 2021) in PyTorch for an NVIDIA H100.

The PyTorch/CUDA port of the ``repro`` package: the same low-code API,
config tree and history; the sequential, batched and async (FedBuff)
engines on hand-written CUDA kernels for FedAvg, STC and int8 compression;
the paper's three benchmark models (``femnist_cnn``, ``shakespeare_lstm``,
``cifar_resnet18``) and its strategy plugins (``core.strategies``); and
federated LoRA fine-tuning of decoder LMs (``client.finetune="lora"``)
with hand-written flash-attention kernels behind ``REPRO_FLASH_ATTN=1``.

    import repro_torch as easyfl
    easyfl.init({"model": "femnist_cnn", "dataset": "femnist",
                 "resources": {"execution": "batched"}})
    easyfl.run()

Entry points run on CUDA.  ``set_device("cpu")`` runs them on the CPU; with
no CUDA device and no such call they raise instead of falling back.
``set_devices([...])`` lists the devices that ``resources.distributed=
"data"`` shards the batched cohort over, one shard an entry.
"""
from repro_torch.core.api import (  # noqa: F401
    init, register_client, register_dataset, register_model, register_server,
    reset, run, start_client, start_server, tracker,
)
from repro_torch.kernels.ops import (  # noqa: F401
    get_device, get_devices, set_device, set_devices,
)

__version__ = "0.1.0"
