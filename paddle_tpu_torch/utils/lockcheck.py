"""lockdep-style runtime lock-order checking (opt-in, debug only;
counterpart of ``paddle_tpu/utils/lockcheck.py``, the same code).

A static lock-order checker sees only LEXICALLY nested ``with`` scopes — an acquisition chain that runs
through a call boundary is invisible to it.  This module closes that
gap at runtime: with ``PADDLE_TPU_LOCKCHECK=1`` in the environment,
the serving engine and the async checkpoint writer construct their
locks through :func:`make_lock`, which hands back a :class:`DebugLock`
proxy instead of a plain ``threading.Lock``.

Every ``DebugLock`` belongs to a named ordering CLASS (lockdep's
``lock_class``): all per-tenant locks share the class
``"serving.engine.tenant"``, so an ordering rule is learned once per
class, not per instance.  On each acquire the proxy records edges
``held-class -> acquired-class`` into a process-global graph and
asserts the new edge closes no cycle; a violation raises (and records)
:class:`LockOrderError` naming the inverted chain — the deadlock is
reported at the first inconsistent acquisition, not when two threads
finally interleave into it.

Off (the default), :func:`make_lock` returns a plain
``threading.Lock`` — zero overhead, byte-identical behavior.

The engine's classes are the JAX engine's, so the edges one run of each
package observes can be compared.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Set

__all__ = ["DebugLock", "LockOrderError", "make_lock", "enabled",
           "edges", "violations", "reset"]


class LockOrderError(AssertionError):
    """Two lock classes were acquired in inconsistent orders — a
    potential deadlock the moment two threads interleave."""


_graph_lock = threading.Lock()
_edges: Dict[str, Set[str]] = {}
_violations: List[str] = []
_tls = threading.local()
_acquires = 0          # approximate (unlocked +=): test liveness signal


def enabled() -> bool:
    return os.environ.get("PADDLE_TPU_LOCKCHECK", "") not in ("", "0")


def make_lock(name: str):
    """A lock for ordering class ``name``: a :class:`DebugLock` when
    ``PADDLE_TPU_LOCKCHECK=1``, else a plain ``threading.Lock``."""
    if enabled():
        return DebugLock(name)
    return threading.Lock()


def edges() -> Dict[str, Set[str]]:
    """Snapshot of the observed acquisition graph (class -> classes
    acquired while it was held)."""
    with _graph_lock:
        return {k: set(v) for k, v in _edges.items()}


def violations() -> List[str]:
    with _graph_lock:
        return list(_violations)


def acquires() -> int:
    """How many DebugLock acquisitions happened since reset() —
    approximate; lets tests assert the proxy was actually exercised."""
    return _acquires


def reset() -> None:
    global _acquires
    with _graph_lock:
        _edges.clear()
        _violations[:] = []
        _acquires = 0


def _held_stack() -> List[str]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _path_exists(src: str, dst: str) -> bool:
    """Reachability in the edge graph (call under ``_graph_lock``)."""
    seen = {src}
    stack = [src]
    while stack:
        cur = stack.pop()
        if cur == dst:
            return True
        for nxt in _edges.get(cur, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append(nxt)
    return False


def _check_edge(held: str, new: str) -> None:
    with _graph_lock:
        if held == new:
            msg = (f"lock order violation: nested acquisition within "
                   f"ordering class {new!r} (self-deadlock risk for "
                   f"non-reentrant locks)")
            _violations.append(msg)
            raise LockOrderError(msg)
        # adding held->new: a pre-existing new~>held path means the
        # opposite order was already observed somewhere — cycle
        if new in _edges and _path_exists(new, held):
            msg = (f"lock order violation: acquiring {new!r} while "
                   f"holding {held!r}, but the opposite order "
                   f"{new!r} -> ... -> {held!r} was already observed")
            _violations.append(msg)
            raise LockOrderError(msg)
        _edges.setdefault(held, set()).add(new)


class DebugLock:
    """Order-asserting proxy around ``threading.Lock`` (context manager
    plus the acquire/release/locked surface the runtime uses)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1):
        global _acquires
        for held in _held_stack():
            _check_edge(held, self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            _held_stack().append(self.name)
            _acquires += 1
        return got

    def release(self) -> None:
        self._lock.release()
        stack = _held_stack()
        # remove the most recent entry for this class (releases may be
        # out of acquisition order; class names can repeat only across
        # distinct instances, which the self-edge check already rejects
        # while nested)
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "DebugLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"DebugLock({self.name!r})"
