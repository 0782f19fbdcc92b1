"""Layer definitions (registry-backed); importing this package registers
every ported layer kind, as ``paddle_tpu/layers/__init__.py`` does for the
full catalog."""

from paddle_tpu_torch.layers import attention  # position / multi-head attention
from paddle_tpu_torch.layers import common     # data, fc, ..., slice
from paddle_tpu_torch.layers import conv       # conv, pool, BN, conv_bn, ...
from paddle_tpu_torch.layers import cost       # classification/sum cost
from paddle_tpu_torch.layers import recurrent  # lstm, gru, bigru, steps
from paddle_tpu_torch.layers import rnn_group  # recurrent_group
from paddle_tpu_torch.layers import sequence   # last_seq, first_seq
