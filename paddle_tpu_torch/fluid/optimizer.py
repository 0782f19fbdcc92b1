"""Fluid optimizers: ``minimize`` = append_backward + optimizer ops.

Mirrors ``python/paddle/v2/fluid/optimizer.py:29`` — optimizers are compiled
into the program as ops (sgd/momentum/adam/... registered in ``ops.py``,
matching the reference's optimizer *operators*), with accumulator state as
persistable global vars initialized in the startup program.
"""

from __future__ import annotations

from typing import List, Optional

from paddle_tpu_torch.fluid import framework, layers
from paddle_tpu_torch.fluid import regularizer as reg_mod
from paddle_tpu_torch.fluid.backward import append_backward
from paddle_tpu_torch.fluid.framework import unique_name


class Optimizer:
    def __init__(self, learning_rate: float = 0.001, regularization=None,
                 global_clip=None):
        self._lr_value = learning_rate
        self._lr_vars = {}  # per-program: a Program's ops must reference
        self.regularization = regularization  # vars living in that program
        self.global_clip = global_clip

    def _lr(self):
        prog = framework.default_main_program()
        key = id(prog)
        if key not in self._lr_vars:
            self._lr_vars[key] = layers.create_global_var(
                shape=(1,), value=self._lr_value, dtype="float32",
                persistable=True, name=unique_name("learning_rate"))
        return self._lr_vars[key]

    def _acc(self, param, suffix: str, value: float = 0.0, shape=None):
        return layers.create_global_var(
            shape=shape if shape is not None else param.shape, value=value,
            dtype=param.dtype, persistable=True,
            name=unique_name(f"{param.name}_{suffix}"))

    def _append_optimize_op(self, block, param, grad):
        raise NotImplementedError

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        prog = loss.program
        startup = (startup_program or prog.startup_program
                   or framework.default_startup_program())
        with framework.program_guard(prog, startup):
            params_grads = append_backward(loss, parameter_list,
                                           no_grad_set)
            block = prog.global_block()
            params_grads = reg_mod.append_regularization_ops(
                params_grads, self.regularization)
            from paddle_tpu_torch.fluid import clip as clip_mod
            params_grads = clip_mod.append_gradient_clip_ops(
                params_grads, self.global_clip)
            optimize_ops = []
            for param, grad in params_grads:
                optimize_ops.append(
                    self._append_optimize_op(block, param, grad))
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def _append_optimize_op(self, block, param, grad):
        return block.append_op(
            "sgd",
            inputs={"Param": [param], "Grad": [grad],
                    "LearningRate": [self._lr()]},
            outputs={"ParamOut": [param]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate, momentum: float = 0.9,
                 use_nesterov: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _append_optimize_op(self, block, param, grad):
        vel = self._acc(param, "velocity")
        return block.append_op(
            "momentum",
            inputs={"Param": [param], "Grad": [grad], "Velocity": [vel],
                    "LearningRate": [self._lr()]},
            outputs={"ParamOut": [param], "VelocityOut": [vel]},
            attrs={"mu": self.momentum, "use_nesterov": self.use_nesterov})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, epsilon: float = 1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.epsilon = epsilon

    def _append_optimize_op(self, block, param, grad):
        moment = self._acc(param, "moment")
        return block.append_op(
            "adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "LearningRate": [self._lr()]},
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"epsilon": self.epsilon})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, block, param, grad):
        m1 = self._acc(param, "moment1")
        m2 = self._acc(param, "moment2")
        b1p = self._acc(param, "beta1_pow", value=self.beta1, shape=(1,))
        b2p = self._acc(param, "beta2_pow", value=self.beta2, shape=(1,))
        return block.append_op(
            "adam",
            inputs={"Param": [param], "Grad": [grad], "Moment1": [m1],
                    "Moment2": [m2], "LearningRate": [self._lr()],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [param], "Moment1Out": [m1],
                     "Moment2Out": [m2], "Beta1PowOut": [b1p],
                     "Beta2PowOut": [b2p]},
            attrs={"beta1": self.beta1, "beta2": self.beta2,
                   "epsilon": self.epsilon})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _append_optimize_op(self, block, param, grad):
        moment = self._acc(param, "moment")
        inf_norm = self._acc(param, "inf_norm")
        b1p = self._acc(param, "beta1_pow", value=self.beta1, shape=(1,))
        return block.append_op(
            "adamax",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "InfNorm": [inf_norm], "LearningRate": [self._lr()],
                    "Beta1Pow": [b1p]},
            outputs={"ParamOut": [param], "MomentOut": [moment],
                     "InfNormOut": [inf_norm], "Beta1PowOut": [b1p]},
            attrs={"beta1": self.beta1, "beta2": self.beta2,
                   "epsilon": self.epsilon})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.epsilon = decay, epsilon

    def _append_optimize_op(self, block, param, grad):
        moment = self._acc(param, "moment")
        return block.append_op(
            "decayed_adagrad",
            inputs={"Param": [param], "Grad": [grad], "Moment": [moment],
                    "LearningRate": [self._lr()]},
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"decay": self.decay, "epsilon": self.epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.epsilon = rho, epsilon

    def _append_optimize_op(self, block, param, grad):
        ag = self._acc(param, "avg_squared_grad")
        au = self._acc(param, "avg_squared_update")
        return block.append_op(
            "adadelta",
            inputs={"Param": [param], "Grad": [grad],
                    "AvgSquaredGrad": [ag], "AvgSquaredUpdate": [au]},
            outputs={"ParamOut": [param], "AvgSquaredGradOut": [ag],
                     "AvgSquaredUpdateOut": [au]},
            attrs={"rho": self.rho, "epsilon": self.epsilon})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate, decay=0.9, momentum=0.0,
                 epsilon=1e-10, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.momentum, self.epsilon = decay, momentum, epsilon

    def _append_optimize_op(self, block, param, grad):
        ms = self._acc(param, "mean_square")
        mom = self._acc(param, "momentum_acc")
        return block.append_op(
            "rmsprop",
            inputs={"Param": [param], "Grad": [grad], "MeanSquare": [ms],
                    "Moment": [mom], "LearningRate": [self._lr()]},
            outputs={"ParamOut": [param], "MeanSquareOut": [ms],
                     "MomentOut": [mom]},
            attrs={"decay": self.decay, "momentum": self.momentum,
                   "epsilon": self.epsilon})


# fluid-style aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
