"""Parameter / extra-layer attributes (the port's copy of
``paddle_tpu/attr.py``).

Reference: python/paddle/trainer_config_helpers/attrs.py — ParameterAttribute
(initial_std, learning_rate, l1/l2 decay, sparse flags) and ExtraLayerAttribute
(drop_rate, device). Device pinning has no TPU meaning (sharding is declared
via paddle_tpu.parallel instead) and is accepted-but-ignored for API parity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class ParamAttr:
    name: Optional[str] = None
    initializer: Any = None          # Initializer / name / float
    learning_rate: float = 1.0
    l1_rate: float = 0.0
    l2_rate: float = 0.0
    is_static: bool = False
    gradient_clipping_threshold: float = 0.0
    sparse_update: bool = False      # embedding tables: sharded-gather path


# reference spells it ParameterAttribute
ParameterAttribute = ParamAttr


@dataclasses.dataclass
class ExtraAttr:
    error_clipping_threshold: float = 0.0
    drop_rate: float = 0.0
    device: Optional[int] = None     # accepted for parity; ignored on TPU


ExtraLayerAttribute = ExtraAttr
