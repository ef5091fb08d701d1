from repro_torch.core.strategies.fedprox import FedProxClient, fedprox_config  # noqa: F401
from repro_torch.core.strategies.stc import STCClient, STCServer, stc_config  # noqa: F401
from repro_torch.core.strategies.fedreid import FedReIDClient  # noqa: F401
from repro_torch.core.strategies.powerofchoice import PowerOfChoiceServer  # noqa: F401
from repro_torch.core.strategies.fedbuff import FedBuffServer  # noqa: F401
