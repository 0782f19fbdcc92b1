"""Training events (reference: python/paddle/v2/event.py:58-101); the
port's copy of ``paddle_tpu/event.py``.

The trainer's event loop fires these into the user's event_handler —
BeginPass/EndPass/BeginIteration/EndIteration(+cost,+metrics)/EndForwardBackward,
plus TestResult after evaluation, exactly mirroring the v2 API.
"""

from __future__ import annotations


class WithMetric:
    def __init__(self, metrics: dict):
        self.metrics = dict(metrics or {})


class BeginPass:
    def __init__(self, pass_id: int):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id: int, evaluator=None, metrics=None):
        super().__init__(metrics or {})
        self.pass_id = pass_id
        self.evaluator = evaluator


class BeginIteration:
    def __init__(self, pass_id: int, batch_id: int):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndForwardBackward:
    def __init__(self, pass_id: int, batch_id: int, gm=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.gm = gm


class EndIteration(WithMetric):
    """`cost` converts the device scalar lazily on first access, so the
    training loop does not wait for the card unless the handler actually
    reads the value."""

    def __init__(self, pass_id: int, batch_id: int, cost, metrics=None):
        super().__init__(metrics or {})
        self.pass_id = pass_id
        self.batch_id = batch_id
        self._cost = cost

    @property
    def cost(self) -> float:
        if not isinstance(self._cost, float):
            self._cost = float(self._cost)
        return self._cost


class TestResult(WithMetric):
    def __init__(self, cost: float, metrics=None):
        super().__init__(metrics or {})
        self.cost = cost
