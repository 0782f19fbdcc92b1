"""Fleet scale-out: spawn replica serving processes and read their
ready lines (counterpart of ``paddle_tpu/serving/fleet.py``).

``python -m paddle_tpu_torch serve --port 0`` binds a free port and prints
ONE machine-readable JSON line on stdout::

    {"ptpu_serve": {"role": "replica", "url": "http://127.0.0.1:40123",
                    "port": 40123, "pid": 12345, ...}}

These helpers spawn such processes (stdout and stderr into a log file per
replica), wait for the ready line and return a ``Replica`` with the bound
URL: what ``serve --fleet N`` and the fleet tests share.

``stop()`` sends SIGINT, the serve command's clean drain (it deregisters
from the router given by ``--router_url``, then drains the engine), and
escalates to SIGKILL past the timeout; ``kill()`` is the crash a test
injects.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

__all__ = ["Replica", "spawn_replica", "spawn_fleet", "replica_argv",
           "READY_KEY"]

#: top-level key of the machine-readable ready line `serve` prints.
READY_KEY = "ptpu_serve"


def replica_argv(model: str, *, port: int = 0,
                 router_url: Optional[str] = None,
                 python: Optional[str] = None,
                 extra: Sequence[str] = ()) -> List[str]:
    """The ``python -m paddle_tpu_torch serve`` argv for one replica."""
    argv = [python or sys.executable, "-m", "paddle_tpu_torch", "serve",
            "--model", model, "--port", str(port)]
    if router_url:
        argv += ["--router_url", router_url]
    argv += list(extra)
    return argv


class Replica:
    """Handle on one spawned replica process."""

    def __init__(self, proc: subprocess.Popen, url: str, port: int,
                 pid: int, log_path: str):
        self.proc = proc
        self.url = url
        self.port = port
        self.pid = pid
        self.log_path = log_path

    def alive(self) -> bool:
        return self.proc.poll() is None

    def log_tail(self, n: int = 4000) -> str:
        return _tail(self.log_path, n)

    def stop(self, timeout_s: float = 30.0) -> int:
        """Clean drain: SIGINT (deregister, then the engine's drain),
        SIGKILL past the timeout.  Returns the exit code."""
        if self.alive():
            try:
                self.proc.send_signal(signal.SIGINT)
            except (ProcessLookupError, OSError):
                pass
            try:
                return self.proc.wait(timeout_s)
            except subprocess.TimeoutExpired:
                self.kill()
        return self.proc.wait(10.0)

    def kill(self) -> None:
        """SIGKILL: the crash a test injects."""
        if self.alive():
            try:
                self.proc.kill()
            except (ProcessLookupError, OSError):
                pass

    def __repr__(self) -> str:
        state = "alive" if self.alive() else f"exit={self.proc.poll()}"
        return f"Replica({self.url}, pid={self.pid}, {state})"


def _wait_ready(proc: subprocess.Popen, log_path: str,
                timeout_s: float) -> dict:
    """Poll the replica's log for the ready line; raise (with the log
    tail) if the process exits or the timeout elapses first."""
    t0 = time.perf_counter()
    pos = 0
    buf = b""
    while True:
        try:
            with open(log_path, "rb") as f:
                f.seek(pos)
                chunk = f.read()
        except OSError:
            chunk = b""
        if chunk:
            pos += len(chunk)
            buf += chunk
            *lines, buf = buf.split(b"\n")
            for line in lines:
                line = line.strip()
                if not line.startswith(b"{"):
                    continue
                try:
                    doc = json.loads(line.decode())
                except (ValueError, UnicodeDecodeError):
                    continue
                if isinstance(doc, dict) and READY_KEY in doc:
                    return doc[READY_KEY]
        if proc.poll() is not None:
            raise RuntimeError(
                f"replica exited ({proc.returncode}) before its ready "
                f"line; log tail:\n"
                + _tail(log_path))
        if time.perf_counter() - t0 > timeout_s:
            proc.kill()
            raise RuntimeError(
                f"replica produced no ready line within {timeout_s}s; "
                f"log tail:\n" + _tail(log_path))
        time.sleep(0.05)


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "r", errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return "<no log>"


def spawn_replica(model: str, *, port: int = 0,
                  router_url: Optional[str] = None,
                  extra: Sequence[str] = (),
                  env: Optional[dict] = None,
                  log_dir: Optional[str] = None,
                  startup_timeout_s: float = 300.0,
                  python: Optional[str] = None) -> Replica:
    """Spawn one replica serving process and wait for its ready line.

    ``extra`` is appended to the serve argv (``--buckets``, quota flags,
    ``--device``, ...); ``env`` replaces the child environment (default:
    inherit).  stdout+stderr land in a log file
    under ``log_dir`` (default: a fresh temp dir)."""
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="ptt_fleet_")
    os.makedirs(log_dir, exist_ok=True)
    log_path = os.path.join(
        log_dir, f"replica-{int(time.time() * 1e3) % 10 ** 9}-"
                 f"{os.getpid()}-{len(os.listdir(log_dir))}.log")
    argv = replica_argv(model, port=port, router_url=router_url,
                        python=python, extra=extra)
    with open(log_path, "wb") as log_f:
        proc = subprocess.Popen(argv, stdout=log_f,
                                stderr=subprocess.STDOUT,
                                env=env, stdin=subprocess.DEVNULL)
    ready = _wait_ready(proc, log_path, startup_timeout_s)
    return Replica(proc, ready["url"], int(ready["port"]),
                   int(ready.get("pid", proc.pid)), log_path)


def spawn_fleet(n: int, model: str, **kw) -> List[Replica]:
    """Spawn ``n`` replicas, one after another (each waits for its ready
    line, so a broken config fails fast with one readable log)."""
    replicas: List[Replica] = []
    try:
        for _ in range(n):
            replicas.append(spawn_replica(model, **kw))
    except Exception:
        for rep in replicas:
            rep.kill()
        raise
    return replicas
