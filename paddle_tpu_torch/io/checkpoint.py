"""Checkpoint reading (and a minimal parameter writer) in the JAX
package's snapshot layout, ``paddle_tpu/io/checkpoint.py``.

A snapshot is a directory ``pass-%05d/`` or ``step-%09d/`` holding
``params.npz`` (flat keys ``layer::param``), ``opt_state.npz``, optional
``model_state.npz`` / ``frozen.npz``, and ``manifest.json`` with a SHA-256
and byte count per payload.  ``load`` verifies before it reads and picks
the newest snapshot that verifies; unlike the JAX loader it never renames
(quarantines) a corrupt snapshot - a server reads, it does not repair.
Multi-host sharded payloads (``*.shard*.npz``) are not read yet.

``save_params`` writes a parameter-only pass snapshot in the same layout
(with an empty ``opt_state.npz``), so a machine without JAX can make a
snapshot that both packages load.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import numpy as np

_SEP = "::"
_PASS_RE = re.compile(r"^pass-(\d{5})$")
_STEP_RE = re.compile(r"^step-(\d{9})$")
MANIFEST_FORMAT = 2


class CheckpointCorrupt(IOError):
    """A snapshot failed checksum/read verification."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif v is not None:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat):
    """Flat ``layer::param`` keys -> ``{layer: {param: array}}``.  Split at
    the first separator only: a recurrent group's parameters are named
    ``<step layer>::<param>`` under the group's layer (every tree this
    module reads is two levels deep)."""
    tree = {}
    for key, val in flat.items():
        layer, _, pname = key.partition(_SEP)
        tree.setdefault(layer, {})[pname] = val
    return tree


def _load_tree(path: str) -> dict:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint piece {path!r} missing (sharded multi-host "
            f"payloads are not read by this package yet)")
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files})


def verify_snapshot(d: str) -> dict:
    """Checksum-verify a snapshot dir; returns its manifest.  Raises
    ``CheckpointCorrupt`` on an unreadable manifest, a missing payload or
    a size/checksum mismatch."""
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"{d}: unreadable manifest: {e}") from e
    for fname, info in (manifest.get("files") or {}).items():
        path = os.path.join(d, fname)
        if not os.path.exists(path):
            raise CheckpointCorrupt(f"{d}: payload {fname} missing")
        if os.path.getsize(path) != info.get("bytes"):
            raise CheckpointCorrupt(
                f"{d}: payload {fname} is {os.path.getsize(path)} bytes, "
                f"manifest says {info.get('bytes')}")
        if _sha256_file(path) != info.get("sha256"):
            raise CheckpointCorrupt(
                f"{d}: payload {fname} fails its SHA-256 check")
    return manifest


def _candidates(dirname: str):
    """Snapshot dirs newest-first: highest recorded global_step; at a tie
    a pass snapshot beats a step one; legacy pass dirs without a step
    order by pass id below anything that records one."""
    out = []
    if not os.path.isdir(dirname):
        return out
    for name in os.listdir(dirname):
        kind, m = "pass", _PASS_RE.match(name)
        if not m:
            kind, m = "step", _STEP_RE.match(name)
        if not m:
            continue
        d = os.path.join(dirname, name)
        if not os.path.exists(os.path.join(d, "manifest.json")):
            continue
        num = int(m.group(1))
        gstep = None
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                gstep = json.load(f).get("global_step")
        except (OSError, ValueError):
            pass                          # unreadable: fails verify later
        if isinstance(gstep, (int, float)):
            key = (1, int(gstep), 1 if kind == "pass" else 0, num)
        elif kind == "step":
            key = (1, num, 0, num)
        else:
            key = (0, num, 1, num)
        out.append((key, kind, num, d))
    out.sort(key=lambda c: c[0], reverse=True)
    return out


def _load_payloads(d: str, manifest: dict) -> dict:
    """The serving payloads: ``params.npz`` as ``trainable`` and, when
    present, ``frozen.npz`` / ``model_state.npz`` (the optimizer state is
    not read: serving has no use for it)."""
    out = {"trainable": _load_tree(os.path.join(d, "params.npz")),
           "model_state": {}, "frozen": {}, "manifest": manifest}
    for name in ("model_state", "frozen"):
        p = os.path.join(d, f"{name}.npz")
        if os.path.exists(p):
            out[name] = _load_tree(p)
    return out


def load(dirname: str) -> dict:
    """Load the newest snapshot (pass or step) under ``dirname`` whose
    checksums verify.  Returns ``{"trainable", "frozen", "model_state",
    "manifest", "dir"}``.  Raises ``FileNotFoundError`` when there is
    none, ``CheckpointCorrupt`` when none verifies."""
    cands = _candidates(dirname)
    if not cands:
        raise FileNotFoundError(f"no checkpoints under {dirname!r}")
    errors = []
    for _key, _kind, _num, d in cands:
        try:
            manifest = verify_snapshot(d)
        except CheckpointCorrupt as e:
            errors.append(str(e))
            continue
        out = _load_payloads(d, manifest)
        out["dir"] = d
        return out
    raise CheckpointCorrupt(
        f"no snapshot under {dirname!r} verifies: " + "; ".join(errors))


def params_of(snapshot: dict) -> dict:
    """The full parameter tree of a loaded snapshot: ``trainable`` with
    ``frozen`` grafted over it."""
    tree = {k: dict(v) for k, v in snapshot["trainable"].items()}
    for layer, params in (snapshot.get("frozen") or {}).items():
        tree.setdefault(layer, {}).update(params)
    return tree


def save_params(dirname: str, values: dict, *, pass_id: int = 0) -> str:
    """Write ``values`` (``{layer: {param: array}}``) as the parameter-only
    snapshot ``pass-%05d`` (empty optimizer state), atomically: payloads
    and manifest go into a tmp dir that is renamed into place last.
    Returns the snapshot dir."""
    final = os.path.join(dirname, f"pass-{pass_id:05d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "params.npz"), **_flatten(values))
    np.savez(os.path.join(tmp, "opt_state.npz"))
    files = {}
    for fname in sorted(os.listdir(tmp)):
        path = os.path.join(tmp, fname)
        with open(path, "rb+") as f:
            os.fsync(f.fileno())
        files[fname] = {"sha256": _sha256_file(path),
                        "bytes": os.path.getsize(path)}
    manifest = {"pass_id": pass_id, "format": MANIFEST_FORMAT,
                "process_count": 1, "files": files}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final
