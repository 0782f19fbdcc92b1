"""Checkpoint/resume: crash-safe snapshots of the full training state, in
the JAX package's layout (counterpart of ``paddle_tpu/io/checkpoint.py``).

A snapshot is a directory ``pass-%05d/`` or ``step-%09d/`` holding
``params.npz`` (flat keys ``layer::param``), ``opt_state.npz`` (``t``,
``slots::layer::param::slot``, and with them ``loss_scale::*``, ``avg::*``
and ``avg_n`` where the run has them), optional ``model_state.npz`` /
``frozen.npz``, and ``manifest.json``: ``pass_id``, ``format`` 2,
``process_count``, a step snapshot's ``global_step``, ``batches_done`` and
``mid_pass``, and a SHA-256 and byte count per payload.  Both packages
write and read the same files.  The trainer's random stream rides in the
manifest under ``torch_rng`` (the JAX package's ``rng`` key holds a JAX
key, which this package neither writes nor reads).

Crash safety, as the JAX package's:

  * a snapshot becomes visible atomically: payloads go into a tmp dir,
    every payload and the directory entries are fsync'd before the
    ``os.replace`` that publishes it, so a SIGKILL or a power loss costs
    at most the snapshot in progress;
  * ``load()`` verifies before it adopts and, in auto mode, falls back to
    the newest snapshot that verifies: the corrupt one is quarantined
    (renamed ``<name>.corrupt*``, with a warning) so auto-resume never
    crash-loops on a damaged latest snapshot; ``latest_valid(...,
    quarantine_corrupt=False)`` and ``audit`` read without renaming;
  * step snapshots record the reader position (``pass_id`` +
    ``batches_done``) so the trainer resumes mid-pass bit-equal; their
    frozen payload is content-addressed into ``objects/<sha256>.npz`` by
    hard links; removal renames out of the namespace before it deletes;
  * ``AsyncCheckpointWriter`` moves the write off the step loop (one
    snapshot writing, at most one queued; a writer error surfaces once, on
    the next save or the flush), and with ``reverify_period_s`` its idle
    loop re-verifies the retained step snapshots.

Sharded payloads (``*.shard<K>.npz`` + ``.meta.json``, a multi-host JAX
run's) are read; writing them needs a multi-host layer (``ROADMAP.md``
section 1, item 14), so ``save`` refuses ``process_count > 1``.

Telemetry (the JAX package's catalog, no-ops while it is off):
``checkpoints_total{result}``, ``checkpoint_quarantined_total``,
``checkpoint_reverified_total{result}`` and the background write's
``trainer_checkpoint_save_us{phase="background_write"}``; the writer's
lock is ``lockcheck.make_lock("io.checkpoint.writer")``.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import json
import os
import queue
import re
import shutil
import threading
import time
import warnings
import zipfile
from typing import Callable, Optional

import numpy as np

from paddle_tpu_torch.io import atomic as _atomic
from paddle_tpu_torch.observability import metrics as _metrics
from paddle_tpu_torch.utils import lockcheck as _lockcheck

_M_CKPT = {r: _metrics.counter(
    "checkpoints_total", "snapshot writes by result", result=r)
    for r in ("ok", "error")}
_M_QUARANTINED = _metrics.counter(
    "checkpoint_quarantined_total",
    "snapshots that failed checksum/read verification and were renamed "
    "*.corrupt so auto-resume falls back instead of crash-looping")
_M_REVERIFIED = {r: _metrics.counter(
    "checkpoint_reverified_total",
    "background scrubber re-verifications of retained step snapshots "
    "by result (corrupt ones are quarantined at scrub time, not found "
    "at restore time)", result=r) for r in ("ok", "corrupt")}
_H_WRITE = _metrics.histogram(
    "trainer_checkpoint_save_us",
    "step-snapshot cost split by phase: hot-path hand-off vs the "
    "background device_get + fsync'd write", phase="background_write")

_SEP = "::"
_PASS_RE = re.compile(r"^pass-(\d{5})$")
_STEP_RE = re.compile(r"^step-(\d{9})$")
MANIFEST_FORMAT = 2          # 1 = no per-file checksums (still loadable)
OBJECTS_DIR = "objects"


class CheckpointCorrupt(IOError):
    """A snapshot failed checksum/read verification."""


# ------------------------------------------------------------------ trees
def _leaf_array(v) -> np.ndarray:
    """A host array of one leaf (a tensor, anywhere, or array-like)."""
    if hasattr(v, "detach"):
        v = v.detach()
        if str(v.dtype) == "torch.bfloat16":
            raise TypeError(
                "a bfloat16 leaf has no numpy dtype; masters, slots and "
                "running state are float32 under every precision policy")
        return v.cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix: str = "") -> dict:
    """Nested dicts -> flat ``{"a::b::c": ndarray}``.  None leaves (the
    trainable/frozen partition's placeholders) are skipped."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif v is not None:
            out[key] = _leaf_array(v)
    return out


def _unflatten(flat: dict) -> dict:
    """Flat ``layer::param`` keys -> ``{layer: {param: array}}``.  Split at
    the first separator only: a recurrent group's parameters are named
    ``<step layer>::<param>`` under the group's layer.  A key without a
    separator stays at the top."""
    tree = {}
    for key, val in flat.items():
        layer, sep, pname = key.partition(_SEP)
        if sep:
            tree.setdefault(layer, {})[pname] = val
        else:
            tree[key] = val
    return tree


def _unflatten_opt(flat: dict) -> dict:
    """Flat optimizer-state keys -> the optimizer's tree: ``slots`` is
    ``{layer: {param: {slot: array}}}`` and ``avg`` ``{layer: {param:
    array}}``, the param name being whatever lies between (a group's
    ``step::w``); every other key splits at each separator."""
    tree = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        if parts[0] == "slots" and len(parts) >= 4:
            parts = [parts[0], parts[1], _SEP.join(parts[2:-1]), parts[-1]]
        elif parts[0] == "avg" and len(parts) >= 3:
            parts = [parts[0], parts[1], _SEP.join(parts[2:])]
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _load_tree_sharded(path: str, unflatten=_unflatten) -> dict:
    """Reassemble a multi-host payload: every ``{path}.shard{K}.npz`` with
    its ``.meta.json`` (global shapes and each shard's slices).  A missing
    host's file raises rather than leave zeros or template values."""
    metas = sorted(_glob.glob(f"{path}.shard*.meta.json"))
    full: dict = {}
    covered: dict = {}
    shapes: dict = {}
    replicated: set = set()
    for mpath in metas:
        proc = mpath[len(path) + len(".shard"):-len(".meta.json")]
        with open(mpath) as f:
            meta = json.load(f)
        with np.load(f"{path}.shard{proc}.npz", allow_pickle=False) as z:
            for key, info in meta.items():
                if info["shards"] is None:
                    replicated.add(key)
                    if key in z.files:
                        full[key] = z[key]
                    continue
                if key not in full:
                    full[key] = np.zeros(info["shape"],
                                         np.dtype(info["dtype"]))
                    shapes[key] = info["shape"]
                for j, idx in enumerate(info["shards"]):
                    sl = tuple(slice(a, b) for a, b in idx)
                    full[key][sl] = z[f"{key}{_SEP}__shard{j}__"]
                    covered[key] = covered.get(key, 0) + int(
                        np.prod([b - a for a, b in idx]))
    missing_rep = sorted(replicated - set(full))
    if missing_rep:
        raise IOError(
            f"sharded checkpoint is missing replicated values "
            f"{missing_rep[:5]}{'...' if len(missing_rep) > 5 else ''}: "
            f"the primary host's shard file is missing")
    for key in shapes:
        n = covered.get(key, 0)
        want = int(np.prod(shapes[key])) if shapes[key] else 1
        if n != want:
            raise IOError(
                f"sharded checkpoint incomplete for {key!r}: {n}/{want} "
                f"elements covered: a host's shard files are missing")
    return unflatten(full)


def _load_tree(path: str, unflatten=_unflatten) -> dict:
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            return unflatten({k: z[k] for k in z.files})
    if not _glob.glob(f"{path}.shard*.meta.json"):
        raise FileNotFoundError(
            f"checkpoint piece {path!r} missing (no npz, no shard files)")
    return _load_tree_sharded(path, unflatten)


# ----------------------------------------------------------------- config
class CheckpointConfig:
    """The trainer's checkpoint knobs (the reference's gflags, plus the
    step-granular extensions), as the JAX package's.

    saving_period / save_only_one: per-pass snapshots.
    save_period_steps: also snapshot every N global steps (``step-%09d/``
        with the reader position), so a SIGKILL mid-pass loses at most N
        steps and resume is mid-pass bit-equal.
    async_save: hand step snapshots to a background writer thread (the
        step loop pays a stream-ordered copy and the hand-off); False
        writes them in the step loop.
    keep_step_snapshots: retain only the newest K step snapshots.
    reverify_period_s: the writer thread's idle loop re-verifies every
        retained step snapshot at least this many seconds apart and
        quarantines silent corruption (needs ``async_save``); None off."""

    def __init__(self, dirname: str, saving_period: int = 1,
                 save_only_one: bool = False,
                 save_period_steps: Optional[int] = None,
                 async_save: bool = True,
                 keep_step_snapshots: int = 2,
                 reverify_period_s: Optional[float] = None):
        if save_period_steps is not None and save_period_steps < 1:
            raise ValueError(
                f"save_period_steps must be >= 1, got {save_period_steps}")
        if reverify_period_s is not None and reverify_period_s <= 0:
            raise ValueError(
                f"reverify_period_s must be > 0, got {reverify_period_s}")
        self.dirname = dirname
        self.saving_period = saving_period
        self.save_only_one = save_only_one
        self.save_period_steps = save_period_steps
        self.async_save = async_save
        self.keep_step_snapshots = max(1, int(keep_step_snapshots))
        self.reverify_period_s = reverify_period_s


def pass_dir(dirname: str, pass_id: int) -> str:
    return os.path.join(dirname, f"pass-{pass_id:05d}")


def step_dir(dirname: str, global_step: int) -> str:
    return os.path.join(dirname, f"step-{global_step:09d}")


def _list_ids(dirname: str, pattern) -> list:
    if not os.path.isdir(dirname):
        return []
    out = []
    for name in os.listdir(dirname):
        m = pattern.match(name)
        if m and os.path.exists(os.path.join(dirname, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def list_passes(dirname: str) -> list:
    """Finalized pass ids, ascending."""
    return _list_ids(dirname, _PASS_RE)


def list_steps(dirname: str) -> list:
    """Finalized step-snapshot global steps, ascending."""
    return _list_ids(dirname, _STEP_RE)


# ------------------------------------------------------------------- save
def _dedup_payload(path: str, sha: str, store: str) -> bool:
    """Content-address one fsync'd payload into ``store`` by hard link:
    the first sight of a digest links the payload in; a repeat swaps the
    fresh copy for a link to the stored object.  True when the snapshot's
    file now shares the stored inode.  Any OSError keeps the plain copy:
    dedup saves disk, it is never a durability term."""
    obj = os.path.join(store, sha + ".npz")
    try:
        if not os.path.exists(obj):
            os.makedirs(store, exist_ok=True)
            os.link(path, obj)
            _atomic.fsync_dir(store)
            return True
        if os.path.samestat(os.stat(obj), os.stat(path)):
            return True
        lnk = path + ".lnk"
        os.link(obj, lnk)
        os.replace(lnk, path)
        _atomic.fsync_dir(os.path.dirname(path))
        return True
    except OSError:
        return False


def _finalize_snapshot(tmp: str, final: str, manifest: dict) -> None:
    """Checksum and fsync every payload, write the fsync'd manifest last,
    fsync the tmp dir, publish by ``os.replace``, fsync the parent: once
    the rename is visible, everything it names is on stable storage.  A
    step snapshot's ``frozen.npz`` (which no step changes) is
    content-addressed into ``<dirname>/objects/``; the mutable payloads
    keep copies of their own.  Re-publishing a name moves the old
    snapshot to ``<name>.old`` until the new one is in place."""
    dedup_store = None
    if os.path.basename(final).startswith("step-"):
        dedup_store = os.path.join(os.path.dirname(final), OBJECTS_DIR)
    files = {}
    for fname in sorted(os.listdir(tmp)):
        path = os.path.join(tmp, fname)
        if not os.path.isfile(path) or fname == "manifest.json":
            continue
        _atomic.fsync_file(path)
        sha = _atomic.sha256_file(path)
        files[fname] = {"sha256": sha, "bytes": os.path.getsize(path)}
        if dedup_store is not None and fname == "frozen.npz":
            if _dedup_payload(path, sha, dedup_store):
                files[fname]["ref"] = f"{OBJECTS_DIR}/{sha}.npz"
    manifest = dict(manifest)
    manifest["files"] = files
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _atomic.fsync_dir(tmp)
    old = final + ".old"
    if os.path.exists(final):
        if os.path.exists(old):
            shutil.rmtree(old)
        os.replace(final, old)
    os.replace(tmp, final)
    _atomic.fsync_dir(os.path.dirname(final))
    shutil.rmtree(old, ignore_errors=True)


def _savez(path: str, tree) -> None:
    """``np.savez(path, **_flatten(tree))``, byte for byte, with each
    array's data handed to the zip member as one buffer: ``np.savez``
    copies it out in 16 MiB ``tobytes`` chunks that hold the interpreter
    lock, which stalls the training thread while the async writer runs;
    the CRC and the file write here release it."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in _flatten(tree).items():
            if not (arr.flags.c_contiguous or arr.flags.f_contiguous):
                arr = arr.copy()
            header = np.lib.format.header_data_from_array_1_0(arr)
            data = arr.T if header["fortran_order"] else arr
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(f, header)
                f.write(memoryview(data.reshape(-1)).cast("B"))


def _save_snapshot(dirname: str, name: str, manifest: dict, *, trainable,
                   opt_state, model_state, frozen=None) -> str:
    if manifest.get("process_count", 1) > 1:
        raise NotImplementedError(
            "sharded (multi-process) checkpoint writes are not ported to "
            "paddle_tpu_torch yet (ROADMAP.md section 1, item 14)")
    final = os.path.join(dirname, name)
    tmp = final + ".tmp"
    try:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)              # stale tmp from a crashed run
        os.makedirs(tmp, exist_ok=True)
        _savez(os.path.join(tmp, "params.npz"), trainable)
        _savez(os.path.join(tmp, "opt_state.npz"), opt_state)
        if model_state:
            _savez(os.path.join(tmp, "model_state.npz"), model_state)
        if frozen:
            _savez(os.path.join(tmp, "frozen.npz"), frozen)
        _finalize_snapshot(tmp, final, manifest)
    except BaseException as e:
        _M_CKPT["error"].inc()
        # the writer thread counts what this did not (each failed save
        # counts once)
        e._ptpu_save_counted = True
        raise
    _M_CKPT["ok"].inc()
    return final


def save(dirname: str, pass_id: int, *, trainable, opt_state, model_state,
         frozen=None, extra: Optional[dict] = None,
         process_count: int = 1) -> str:
    """Write one pass snapshot atomically; returns the pass dir.  Trees
    hold tensors (anywhere) or arrays; ``extra`` joins the manifest."""
    manifest = {"pass_id": pass_id, "format": MANIFEST_FORMAT,
                "process_count": process_count}
    manifest.update(extra or {})
    return _save_snapshot(dirname, f"pass-{pass_id:05d}", manifest,
                          trainable=trainable, opt_state=opt_state,
                          model_state=model_state, frozen=frozen)


def save_step(dirname: str, global_step: int, *, pass_id: int,
              batches_done: int, trainable, opt_state, model_state,
              frozen=None, extra: Optional[dict] = None,
              process_count: int = 1) -> str:
    """Step-granular mid-pass snapshot.  The manifest records the resume
    point: ``global_step``, and the reader position as ``pass_id`` +
    ``batches_done`` (batches consumed by steps in that pass: resume
    re-creates the reader and skips that many).  Each tree may also come
    already flat, as ``{"a::b": array}`` (``_flatten`` passes it through)."""
    manifest = {"pass_id": pass_id, "global_step": int(global_step),
                "batches_done": int(batches_done), "mid_pass": True,
                "format": MANIFEST_FORMAT, "process_count": process_count}
    manifest.update(extra or {})
    return _save_snapshot(dirname, f"step-{global_step:09d}", manifest,
                          trainable=trainable, opt_state=opt_state,
                          model_state=model_state, frozen=frozen)


def save_params(dirname: str, values: dict, *, pass_id: int = 0) -> str:
    """Write ``values`` (``{layer: {param: array or tensor}}``) as the
    parameter-only snapshot ``pass-%05d`` (an empty ``opt_state.npz``),
    through ``save``.  Returns the snapshot dir."""
    return save(dirname, pass_id, trainable=values, opt_state={},
                model_state={})


# ------------------------------------------------------------------- load
def verify_snapshot(d: str) -> dict:
    """Checksum-verify a finalized snapshot dir; returns its manifest.
    Raises ``CheckpointCorrupt`` on an unreadable manifest, a missing
    payload or a size/checksum mismatch.  Format-1 manifests (no
    checksums) verify trivially."""
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
        if _atomic.sha256_file(path) != info.get("sha256"):
            raise CheckpointCorrupt(
                f"{d}: payload {fname} fails its SHA-256 check")
    return manifest


def quarantine(d: str) -> str:
    """Rename a corrupt snapshot out of the pass-/step- namespace, with a
    warning; returns the new name (``d`` itself if it was already gone)."""
    target = d + ".corrupt"
    i = 0
    while os.path.exists(target):
        i += 1
        target = f"{d}.corrupt{i}"
    try:
        os.rename(d, target)
    except FileNotFoundError:
        # removed concurrently (pruned, or quarantined by another
        # reader): gone is as good as quarantined
        return d
    _M_QUARANTINED.inc()
    warnings.warn(f"checkpoint {d} failed verification; quarantined to "
                  f"{target}", RuntimeWarning)
    return target


def reverify_steps(dirname: str, *, quarantine_corrupt: bool = True) -> dict:
    """One scrub pass over every retained step snapshot: re-run the
    manifest's SHA-256s and (by default) quarantine what fails.  Returns
    ``{"ok": [...], "corrupt": [...]}`` of global steps; a snapshot pruned
    mid-scan is skipped."""
    ok, corrupt = [], []
    for g in list_steps(dirname):
        d = step_dir(dirname, g)
        try:
            verify_snapshot(d)
        except CheckpointCorrupt:
            if not os.path.isdir(d):
                continue
            corrupt.append(g)
            _M_REVERIFIED["corrupt"].inc()
            if quarantine_corrupt:
                quarantine(d)
        else:
            ok.append(g)
            _M_REVERIFIED["ok"].inc()
    return {"ok": ok, "corrupt": corrupt}


def audit(dirname: str) -> dict:
    """Read-only verification of every snapshot under ``dirname`` (pass
    and step; nothing is quarantined): ``checkpoint verify`` prints it."""
    out = {"dir": dirname, "snapshots": {}, "ok": 0, "corrupt": 0}
    names = ([f"pass-{p:05d}" for p in list_passes(dirname)]
             + [f"step-{g:09d}" for g in list_steps(dirname)])
    for name in names:
        try:
            manifest = verify_snapshot(os.path.join(dirname, name))
        except CheckpointCorrupt as e:
            out["snapshots"][name] = {"status": "corrupt", "error": str(e)}
            out["corrupt"] += 1
        else:
            out["snapshots"][name] = {
                "status": "ok", "files": len(manifest.get("files") or {}),
                "global_step": manifest.get("global_step")}
            out["ok"] += 1
    return out


def _candidates(dirname: str) -> list:
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


def snapshot_version(manifest: dict) -> str:
    """``<global_step>-<digest8>``: the recorded global step (a pass
    snapshot without one: its pass id) and 8 hex digits of a SHA-256 over
    the manifest's per-file checksums; equal payload bytes, equal
    version."""
    files = manifest.get("files") or {}
    h = hashlib.sha256()
    for fname in sorted(files):
        h.update(fname.encode())
        h.update(str(files[fname].get("sha256", "")).encode())
    step = manifest.get("global_step")
    if step is None:
        step = manifest.get("pass_id", 0)
    return f"{int(step)}-{h.hexdigest()[:8]}"


def latest_valid(dirname: str, *, quarantine_corrupt: bool = True) -> dict:
    """The newest snapshot under ``dirname`` that verifies: the one
    resolution shared by auto-resume (``load``), ``serve --params`` and
    ``checkpoint latest``.  A candidate failing its checksums is
    quarantined and the next one tried; ``quarantine_corrupt=False``
    skips it read-only.  A snapshot whose manifest vanished mid-read (a
    racing prune) is skipped uncounted.  Returns ``{"dir", "kind",
    "num", "manifest", "global_step", "model_version", "fallbacks"}``;
    raises ``FileNotFoundError`` when there is no snapshot at all,
    ``CheckpointCorrupt`` when none verifies."""
    cands = _candidates(dirname)
    if not cands:
        raise FileNotFoundError(f"no checkpoints under {dirname!r}")
    fallbacks, errors = 0, []
    for _key, kind, num, d in cands:
        try:
            manifest = verify_snapshot(d)
        except CheckpointCorrupt as e:
            if not os.path.exists(os.path.join(d, "manifest.json")):
                continue
            errors.append(str(e))
            if quarantine_corrupt:
                quarantine(d)
            fallbacks += 1
            continue
        return {"dir": d, "kind": kind, "num": num, "manifest": manifest,
                "global_step": manifest.get("global_step"),
                "model_version": snapshot_version(manifest),
                "fallbacks": fallbacks}
    raise CheckpointCorrupt(
        f"all {len(cands)} snapshots under {dirname!r} failed verification"
        + (" (quarantined)" if quarantine_corrupt else "") + ": "
        + "; ".join(errors))


def peek_version(dirname: str) -> Optional[str]:
    """The newest candidate's model version, unverified (one manifest
    read); None when there is none or its manifest is unreadable."""
    cands = _candidates(dirname)
    if not cands:
        return None
    try:
        with open(os.path.join(cands[0][3], "manifest.json")) as f:
            return snapshot_version(json.load(f))
    except (OSError, ValueError):
        return None


def _load_payloads(d: str, manifest: dict) -> dict:
    out = {"trainable": _load_tree(os.path.join(d, "params.npz")),
           "opt_state": _load_tree(os.path.join(d, "opt_state.npz"),
                                   _unflatten_opt),
           "model_state": {}, "frozen": {}, "manifest": manifest,
           "dir": d}
    for name in ("model_state", "frozen"):
        p = os.path.join(d, f"{name}.npz")
        if os.path.exists(p) or _glob.glob(p + ".shard*.npz"):
            out[name] = _load_tree(p)
    return out


def load_snapshot(d: str, manifest: Optional[dict] = None) -> dict:
    """Verify and load one exact snapshot dir (no fallback); a
    ``manifest`` that ``latest_valid`` just verified skips the second
    verification."""
    if manifest is None:
        manifest = verify_snapshot(d)
    return _load_payloads(d, manifest)


def load(dirname: str, pass_id: Optional[int] = None) -> dict:
    """Load a snapshot.

    With ``pass_id``: that exact pass, verified (``CheckpointCorrupt`` if
    it fails).  Auto mode (``pass_id=None``): the newest snapshot, pass or
    step, that verifies and reads; one that fails is quarantined and the
    next one tried.  Returns ``{"pass_id", "kind" ("pass" | "step"),
    "fallbacks", "trainable", "opt_state", "model_state", "frozen",
    "manifest", "dir"}``; missing optional pieces come back as {}."""
    if pass_id is not None:
        if pass_id not in list_passes(dirname):
            raise FileNotFoundError(
                f"pass-{pass_id:05d} not in {list_passes(dirname)}")
        d = pass_dir(dirname, pass_id)
        out = _load_payloads(d, verify_snapshot(d))
        out.update(pass_id=pass_id, kind="pass", fallbacks=0)
        return out
    fallbacks = 0
    while True:
        cand = latest_valid(dirname)      # raises when none / all bad
        fallbacks += cand["fallbacks"]
        d, kind, num = cand["dir"], cand["kind"], cand["num"]
        manifest = cand["manifest"]
        try:
            out = _load_payloads(d, manifest)
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            if not os.path.exists(os.path.join(d, "manifest.json")):
                continue                  # removed while read: not corrupt
            if not isinstance(e, CheckpointCorrupt):
                warnings.warn(f"checkpoint {d} unreadable: {e}",
                              RuntimeWarning)
            quarantine(d)
            fallbacks += 1
            continue
        out.update(pass_id=int(manifest.get("pass_id",
                                            num if kind == "pass" else 0)),
                   kind=kind, fallbacks=fallbacks)
        return out


def params_of(snapshot: dict) -> dict:
    """The full parameter tree of a loaded snapshot: ``trainable`` with
    ``frozen`` grafted over it."""
    tree = {k: dict(v) for k, v in snapshot["trainable"].items()}
    for layer, params in (snapshot.get("frozen") or {}).items():
        tree.setdefault(layer, {}).update(params)
    return tree


def graft(template, loaded):
    """Overlay loaded values onto a live tree, keeping the template's
    structure (and its None placeholders, which a save skips)."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict):
            return template
        return {k: graft(v, loaded.get(k)) for k, v in template.items()}
    return template if loaded is None else loaded


# ---------------------------------------------------------------- removal
def _remove_snapshot_dir(d: str) -> None:
    """Rename the dir out of the pass-/step- namespace, then delete: a
    SIGKILL mid-delete never leaves a listed snapshot with payloads
    missing.  A stale ``*.pruned`` dir is swept by the next prune."""
    trash = d + ".pruned"
    if os.path.isdir(trash):
        shutil.rmtree(trash, ignore_errors=True)
    try:
        os.replace(d, trash)
    except OSError:
        shutil.rmtree(d, ignore_errors=True)
        return
    shutil.rmtree(trash, ignore_errors=True)


def _sweep_pruned(dirname: str) -> None:
    try:
        names = os.listdir(dirname)
    except OSError:
        return
    for name in names:
        if name.endswith(".pruned"):
            shutil.rmtree(os.path.join(dirname, name), ignore_errors=True)


def prune_old(dirname: str, keep_pass: int) -> None:
    """``save_only_one``: drop every pass dir except ``keep_pass``."""
    _sweep_pruned(dirname)
    for p in list_passes(dirname):
        if p != keep_pass:
            _remove_snapshot_dir(pass_dir(dirname, p))


def prune_steps(dirname: str, keep: int = 2) -> None:
    """Drop all but the newest ``keep`` step snapshots (a finished pass
    supersedes every step snapshot before it: the pass-end save calls this
    with keep=0), then sweep the unreferenced objects."""
    _sweep_pruned(dirname)
    steps = list_steps(dirname)
    drop = steps if keep <= 0 else steps[:-keep]
    for g in drop:
        _remove_snapshot_dir(step_dir(dirname, g))
    if drop:
        _gc_objects(dirname)


def _gc_objects(dirname: str) -> None:
    """Unlink every object of the store whose link count fell to 1 (no
    retained snapshot links it)."""
    store = os.path.join(dirname, OBJECTS_DIR)
    try:
        names = os.listdir(store)
    except OSError:
        return
    for name in names:
        path = os.path.join(store, name)
        try:
            if os.stat(path).st_nlink <= 1:
                os.unlink(path)
        except OSError:
            continue


# ----------------------------------------------------------- async writer
class AsyncCheckpointWriter:
    """One background thread draining snapshot jobs, so the step loop
    never waits on a write.  The queue holds at most one job while
    another writes.  ``submit`` returns (and warns of) errors of earlier
    jobs; ``flush`` waits for the queue and returns the rest: each failed
    job surfaces exactly once.  ``session`` counts writes, errors,
    stalls (a submit that waited) and scrubs.

    With ``reverify_period_s`` the thread's idle time is the snapshot
    scrubber: at least that many seconds apart it re-verifies every
    retained step snapshot under ``reverify_dir`` and quarantines silent
    corruption.  Scrubs run only while the queue is empty, so they never
    delay a save and never race the thread's own half-written snapshot."""

    def __init__(self, name: str = "ptpu-ckpt-writer",
                 reverify_period_s: Optional[float] = None,
                 reverify_dir: Optional[str] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._errors: list = []
        # PADDLE_TPU_LOCKCHECK=1 swaps in the order-asserting proxy
        self._lock = _lockcheck.make_lock("io.checkpoint.writer")
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._started = False
        self._reverify_period_s = (float(reverify_period_s)
                                   if reverify_period_s else None)
        self._reverify_dir = reverify_dir
        self._last_scrub = time.perf_counter()
        self.session = {"writes": 0, "errors": 0, "stalls": 0, "scrubs": 0,
                        "reverified_ok": 0, "reverified_corrupt": 0,
                        "write_s": 0.0}

    def _maybe_scrub(self) -> None:
        now = time.perf_counter()
        if now - self._last_scrub < self._reverify_period_s:
            return
        self._last_scrub = now
        try:
            res = reverify_steps(self._reverify_dir)
        except Exception as e:             # noqa: BLE001: never die
            warnings.warn(f"snapshot scrub pass failed: {e!r}",
                          RuntimeWarning)
            return
        self.session["scrubs"] += 1
        self.session["reverified_ok"] += len(res["ok"])
        self.session["reverified_corrupt"] += len(res["corrupt"])

    def _run(self) -> None:
        scrubbing = (self._reverify_period_s is not None
                     and self._reverify_dir is not None)
        while True:
            if scrubbing:
                try:
                    # wake at a quarter period, so a scrub lands within
                    # 1.25 periods of the last one with no saves arriving
                    fn = self._q.get(
                        timeout=max(0.05, self._reverify_period_s / 4))
                except queue.Empty:
                    self._maybe_scrub()
                    continue
            else:
                fn = self._q.get()
            try:
                t0 = time.perf_counter()
                fn()
                dt = time.perf_counter() - t0
                _H_WRITE.observe(dt * 1e6)
                self.session["write_s"] += dt
                self.session["writes"] += 1
            except BaseException as e:
                if not getattr(e, "_ptpu_save_counted", False):
                    _M_CKPT["error"].inc()
                self.session["errors"] += 1
                with self._lock:
                    self._errors.append(e)
            finally:
                self._q.task_done()

    def take_errors(self) -> list:
        with self._lock:
            errs, self._errors = self._errors, []
        return errs

    def submit(self, fn: Callable[[], object]) -> list:
        """Queue one snapshot job; returns (and clears) errors of earlier
        jobs.  Blocks only while a job already waits behind the one being
        written (counted as a stall)."""
        if not self._started:
            self._started = True
            self._thread.start()
        errs = self.take_errors()
        for e in errs:
            warnings.warn(f"previous async checkpoint save failed: {e!r}",
                          RuntimeWarning)
        if self._q.full():
            self.session["stalls"] += 1
        self._q.put(fn)
        return errs

    def flush(self) -> list:
        """Wait for every queued job; returns the pending errors."""
        if self._started:
            self._q.join()
        return self.take_errors()
