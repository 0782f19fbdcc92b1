"""Legacy config-DSL compatibility surface.

Reference: python/paddle/trainer_config_helpers/__init__.py — the module
`paddle train --config=<file>.py` scripts import with
`from paddle.trainer_config_helpers import *`. Re-exports the port's
equivalents under their legacy names, so a reference config file runs
through ``python -m paddle_tpu_torch train --config=`` with only its
import line changed (``from paddle_tpu_torch.trainer_config_helpers
import *``).

Contents: the 117-symbol layer DSL (with *_layer spellings), activation
classes (SigmoidActivation, ...), pooling types, ParamAttr/ExtraAttr,
settings() + optimizer classes, evaluators, and the composite network
helpers.
"""

from paddle_tpu_torch.attr import (ExtraAttr, ExtraLayerAttribute, ParamAttr,
                             ParameterAttribute)
from paddle_tpu_torch.activation import *          # noqa: F401,F403
from paddle_tpu_torch.layer import *               # noqa: F401,F403
from paddle_tpu_torch.layer import (                # legacy *_layer aliases
    AggregateLevel, BaseGeneratedInput, BeamInput, ExpandLevel,
    GeneratedInput, LayerOutput, LayerType, StaticInput, SubsequenceInput,
    layer_support)
from paddle_tpu_torch import layer as _layer_mod
from paddle_tpu_torch.networks import *            # noqa: F401,F403
from paddle_tpu_torch.optimizer import (
    AdaDeltaOptimizer, AdaGradOptimizer, AdamOptimizer, AdamaxOptimizer,
    BaseRegularization, BaseSGDOptimizer, DecayedAdaGradOptimizer,
    L1Regularization, L2Regularization, ModelAverage, MomentumOptimizer,
    RMSPropOptimizer, settings)
from paddle_tpu_torch.pooling import (AvgPooling, BasePoolingType,
                                CudnnAvgInclPadPooling, CudnnAvgPooling,
                                CudnnMaxPooling, MaxPooling,
                                MaxWithMaskPooling, SqrtAvgPooling,
                                SquareRootNPooling, SumPooling)
from paddle_tpu_torch.py_data_provider2 import (CacheType, define_py_data_sources2,
                                          provider)
from paddle_tpu_torch import evaluator as _ev

# legacy evaluator spellings: classification_error_evaluator etc.
# (factories only — dir() would also sweep up typing imports and
# internals; take_pending is the registry accessor, not a factory)
_obj = None
for _name in _ev.__all__:
    if _name in ("Evaluator", "take_pending"):
        continue
    _obj = getattr(_ev, _name)
    if callable(_obj) and not isinstance(_obj, type):
        globals().setdefault(_name + "_evaluator", _obj)
# every layer-DSL symbol (incl. *_layer aliases installed by layer.py)
for _name in dir(_layer_mod):
    if not _name.startswith("_"):
        globals().setdefault(_name, getattr(_layer_mod, _name))

del _name, _obj, _ev, _layer_mod

# operator overloads on LayerOutput; the unary math fns stay namespaced
# (layer_math.tanh etc.) so builtins like abs() are not shadowed in
# legacy config namespaces (the reference likewise only side-effect
# imports this module)
from paddle_tpu_torch.trainer_config_helpers import layer_math  # noqa: E402,F401


def data_layer(name, size=None, height=None, width=None, type=None, **kw):
    """legacy signature: data_layer(name, size) — the sample layout comes
    from the registered @provider's input_types (reference: the provider
    proto defines slot shapes; config_parser only records size). Falls
    back to dense_vector(size) when no provider declares the slot."""
    from paddle_tpu_torch import data_type as _dt
    from paddle_tpu_torch import layer as _l
    from paddle_tpu_torch import py_data_provider2 as _pdp2

    t = type
    if t is None:
        src = _pdp2.get_data_sources()
        if src is not None:
            its = getattr(src["provider"], "input_types", None)
            if isinstance(its, dict) and name in its:
                t = its[name]
    if t is None:
        if size is None:
            raise ValueError(f"data_layer {name!r}: pass size= or type=")
        t = _dt.dense_vector(size)
    return _l.data(name, t, height=height, width=width)
