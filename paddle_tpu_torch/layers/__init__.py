"""Layer definitions (registry-backed); importing this package registers
every ported layer kind, as ``paddle_tpu/layers/__init__.py`` does for the
full catalog."""

from paddle_tpu_torch.layers import attention  # position / multi-head attention
from paddle_tpu_torch.layers import common     # data, fc, embedding, addto
from paddle_tpu_torch.layers import conv       # layer_norm
from paddle_tpu_torch.layers import cost       # classification_cost
