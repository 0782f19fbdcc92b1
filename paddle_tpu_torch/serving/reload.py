"""Weight updates without downtime: serve the checkpoint stream
(counterpart of ``paddle_tpu/serving/reload.py``).

A ``WeightWatcher`` polls a checkpoint directory (the trainer's
``--save_dir``) for a newer snapshot that verifies (``io.checkpoint``'s
``latest_valid``: newest first, a corrupt one quarantined and the next
tried), loads it on its own thread and hands the parameter tree to
``engine.install_version``: whole forwards swap between micro-batches,
decode drains and then swaps, the previous version stays resident for
``POST /reload?rollback=1``, and with ``canary_fraction > 0`` the new
version enters as the canary.

A snapshot that fails verification never touches the serving weights;
when every candidate is corrupt the watcher warns and keeps serving what
it has (counted ``reloads["verify_failed"]``).

    engine = InferenceEngine(out, params, model_version=ver0)
    watcher = WeightWatcher(engine, "ckpts/", period_s=2.0)
    ...
    watcher.close()        # or engine.close(), which joins it

CLI: ``python -m paddle_tpu_torch serve --model cfg.py --watch_dir ckpts/
--reload_period_s 2 --canary_fraction 0.1 --reload_key_file k``.
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Optional

from paddle_tpu_torch.io import checkpoint as _ckpt
from paddle_tpu_torch.parameters import check_fuse_conv_bn_mismatch, tree_keys

__all__ = ["WeightWatcher", "load_from", "snapshot_values"]


def snapshot_values(engine, payloads: dict):
    """A loaded snapshot's parameters grafted onto the engine's active
    version (the serving tree is the template: the snapshot's trainable
    part overlays it, its frozen part too when present, so nothing is
    dropped); a snapshot saved under the other ``fuse_conv_bn`` setting
    raises."""
    with engine._version_lock:
        template = engine._versions[engine._version_active].values
    check_fuse_conv_bn_mismatch(template, tree_keys(
        payloads.get("trainable"), payloads.get("frozen")))
    vals = _ckpt.graft(template, payloads.get("trainable") or {})
    if payloads.get("frozen"):
        vals = _ckpt.graft(vals, payloads["frozen"])
    return vals


def _count_verify_failed(engine) -> None:
    with engine._err_lock:
        engine.session["reloads"]["verify_failed"] += 1


def load_from(engine, dirname: str, *, known: Optional[set] = None,
              source_label: str = "") -> dict:
    """One reload attempt: resolve the newest snapshot under ``dirname``
    that verifies, derive its version (``global_step-digest8``), load,
    graft and install it.  Never touches the serving weights on a
    failure.  Returns the engine's install result, or ``{"result":
    "empty" | "verify_failed" | "no_new", ...}``."""
    if known:
        # the steady state: one manifest read decides no_new (a known id
        # was verified when it was resolved)
        newest = _ckpt.peek_version(dirname)
        if newest is not None and newest in known:
            return {"result": "no_new", "model_version": newest}
    try:
        cand = _ckpt.latest_valid(dirname)
    except FileNotFoundError:
        return {"result": "empty", "dir": dirname}
    except _ckpt.CheckpointCorrupt as e:
        _count_verify_failed(engine)
        warnings.warn(
            f"weight reload from {dirname!r}: every snapshot failed "
            f"verification ({e}); KEEPING the current weights "
            f"(model_version {engine._active_version()})", RuntimeWarning)
        return {"result": "verify_failed", "dir": dirname, "error": str(e)}
    ver = cand["model_version"]
    if known is not None and ver in known:
        return {"result": "no_new", "model_version": ver}
    try:
        # latest_valid just verified this manifest
        payloads = _ckpt.load_snapshot(cand["dir"],
                                       manifest=cand["manifest"])
    except Exception as e:                    # noqa: BLE001 - keep serving
        _count_verify_failed(engine)
        warnings.warn(
            f"weight reload: snapshot {cand['dir']} failed to load "
            f"({e!r}); keeping the current weights", RuntimeWarning)
        return {"result": "verify_failed", "dir": cand["dir"],
                "error": repr(e)}
    res = engine.install_version(ver, snapshot_values(engine, payloads),
                                 source=source_label or cand["dir"])
    res.setdefault("global_step", cand["global_step"])
    res["dir"] = cand["dir"]
    return res


class WeightWatcher:
    """A thread polling ``watch_dir`` every ``period_s`` for a newer
    snapshot that verifies and installing it into ``engine``.
    ``check_now()`` runs one check synchronously (``POST /reload`` shares
    it; one check at a time).  ``close()`` stops the thread and joins it,
    waiting out a load in flight (``install_version`` refuses once the
    engine closed).  ``stats()`` has the session counters."""

    def __init__(self, engine, watch_dir: str, *, period_s: float = 2.0,
                 poll: bool = True, name: str = "ptt-weight-watcher"):
        if period_s <= 0:
            raise ValueError(f"period_s must be > 0, got {period_s}")
        self.engine = engine
        self.watch_dir = str(watch_dir)
        self.period_s = float(period_s)
        # versions already resolved: a poll acts only on a new digest, so
        # a rolled-back snapshot cannot flap back in
        self._known = {engine._active_version()}
        self._check_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.session = {"checks": 0, "swapped": 0, "canary": 0,
                        "pending": 0, "rolled_back": 0,
                        "verify_failed": 0, "no_new": 0, "empty": 0,
                        "refused": 0, "errors": 0}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        engine.attach_watcher(self)
        if poll:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name=name)
            self._thread.start()

    def check_now(self) -> dict:
        """One reload check, serialized against the poll loop."""
        with self._check_lock:
            with self._stats_lock:
                self.session["checks"] += 1
            try:
                res = load_from(self.engine, self.watch_dir,
                                known=self._known)
            except Exception as e:            # noqa: BLE001 - never die
                with self._stats_lock:
                    self.session["errors"] += 1
                warnings.warn(f"weight-watcher check failed: {e!r}",
                              RuntimeWarning)
                return {"result": "error", "error": repr(e)}
            result = res.get("result", "error")
            ver = res.get("model_version")
            if ver and result in ("swapped", "canary", "pending", "no_new",
                                  "refused_bad"):
                self._known.add(ver)
                if len(self._known) > 512:
                    # bounded; a forgotten id re-resolves to no_new or
                    # refused_bad at the engine
                    self._known = {self.engine._active_version(), ver}
            key = "refused" if result.startswith("refused") else result
            with self._stats_lock:
                if key in self.session:
                    self.session[key] += 1
            return res

    def _run(self) -> None:
        while not self._stop.wait(self.period_s):
            self.check_now()

    def stats(self) -> dict:
        with self._stats_lock:
            out = dict(self.session)
        out["watch_dir"] = self.watch_dir
        out["period_s"] = self.period_s
        out["alive"] = bool(self._thread and self._thread.is_alive())
        return out

    def close(self, timeout_s: float = 30.0) -> None:
        """Stop polling and join the thread, within ``timeout_s`` for the
        whole call; a load wedged past it is left to its daemon thread
        (it cannot install once the engine closed).  Idempotent."""
        deadline = time.perf_counter() + max(0.0, timeout_s)
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout_s)
        # a close racing a check_now push: let it finish, bounded
        if self._check_lock.acquire(
                timeout=max(0.05, deadline - time.perf_counter())):
            self._check_lock.release()
        else:
            warnings.warn(
                f"weight watcher close(): an in-flight load did not finish "
                f"within {timeout_s}s; leaving it to the daemon thread (it "
                f"cannot install once the engine closes)", RuntimeWarning)

    def __enter__(self) -> "WeightWatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
