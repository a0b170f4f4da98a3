"""Host profile: numpy tensor math of the reference API."""
from pylabfea_tpu_torch.core.tensors import *  # noqa: F401,F403
