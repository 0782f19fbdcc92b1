"""Shared by the port's serving tests: one small JAX LM carried into the
port with ``params_from_jax``, decoder factories, and ``Gate``, which holds a
decoder's decode step until the test releases it, so that what the engine
does between steps is decided by the test and not by the clock."""

import threading
import time

import numpy as np

import paddle_tpu as paddle
from paddle_tpu.models import transformer as jtr
from paddle_tpu_torch.models import transformer as ttr

VOCAB, DIM, HEADS, LAYERS = 48, 32, 2, 2
MAXLEN = 64
LONG_MAXLEN = 256


def lm(max_len=MAXLEN):
    """(JAX topology, JAX parameters, numpy tree) of the small LM."""
    paddle.init(seed=0)
    cost, _ = jtr.build(vocab_size=VOCAB, max_len=max_len, dim=DIM,
                        num_heads=HEADS, num_layers=LAYERS)
    topo = paddle.Topology(cost, collect_evaluators=False)
    params = paddle.parameters.create(topo)
    values = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in params.values.items()}
    return topo, params, values


def slab(model, max_slots=4, **kw):
    return ttr.SlotDecoder(model, max_slots=max_slots, device="cpu", **kw)


def paged(model, max_slots=4, **kw):
    kw.setdefault("block_size", 8)
    kw.setdefault("step_buckets", (2, 4) if max_slots >= 4 else (max_slots,))
    kw.setdefault("chunk_buckets", (8, 16))
    return ttr.PagedDecoder(model, max_slots=max_slots, device="cpu", **kw)


def wait_until(cond, timeout=30.0, what="condition"):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        if cond():
            return
        time.sleep(0.002)
    raise AssertionError(f"timed out waiting for {what}")


class Gate:
    """Wraps ``decoder.step`` (``mixed_step`` for a paged decoder): each
    call waits for one permit from ``release`` until ``open`` lets every
    call through.  ``calls`` counts the calls entered; ``throttle_s`` adds
    a sleep to every call (a lower bound on each step's time); ``orig`` is
    what a call runs once let through (a test may swap it for a fault).
    The engine duck-types its decoder, so the wrapper is invisible to it;
    it works on the JAX decoders too."""

    def __init__(self, decoder, throttle_s=0.0, closed=True):
        name = "mixed_step" if getattr(decoder, "paged", False) else "step"
        self._sem = threading.Semaphore(0)
        self._open = threading.Event()
        if not closed:
            self._open.set()
        self.calls = 0
        self.orig = getattr(decoder, name)

        def gated(*args, **kw):
            self.calls += 1
            if not self._open.is_set():
                self._sem.acquire()
            if throttle_s:
                time.sleep(throttle_s)
            return self.orig(*args, **kw)

        setattr(decoder, name, gated)

    def release(self, n=1):
        for _ in range(n):
            self._sem.release()

    def step(self):
        """Let exactly one more call through and wait until the engine is
        inside the next one (or idle)."""
        c = self.calls
        self.release()
        wait_until(lambda: self.calls > c, what="the next decode step")

    def open(self):
        self._open.set()
        self.release(4)


def resident(engine, gate, n):
    """Release steps one at a time until ``n`` sequences hold slots."""
    wait_until(lambda: gate.calls >= 1, what="the first decode step")
    while engine.stats()["decode"]["slots_occupied"] < n:
        gate.step()


def request_of(fut):
    """The engine's request record behind a future."""
    return fut._ptt_request()
