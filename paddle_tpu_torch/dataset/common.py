"""Shared dataset plumbing (counterpart of ``paddle_tpu/dataset/common.py``;
reference: v2/dataset/common.py): the cache directory, file splitting and
sharding for several trainers, the seeded generator of the synthetic
streams, and the recordio shards of ``convert`` / ``recordio_reader``.
"""

from __future__ import annotations

import glob as _glob
import os
import pickle

import numpy as np

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu"))


def cache_path(*parts) -> str:
    return os.path.join(DATA_HOME, *parts)


def have_file(*parts) -> bool:
    return os.path.exists(cache_path(*parts))


def must_download(name: str, url_hint: str):
    raise RuntimeError(
        f"dataset {name!r} is not cached under {DATA_HOME} and this "
        f"environment has no network egress. Download {url_hint} there, or "
        f"use synthetic=True for a deterministic synthetic stream.")


def split(reader, line_count: int, suffix="%05d.pkl", dumper=None):
    """split reader output into pickle shard files (reference: common.py
    split), the input side of cluster_files_reader."""
    dumper = dumper or pickle.dump
    out_files = []
    lines = []
    idx = 0
    for item in reader():
        lines.append(item)
        if len(lines) >= line_count:
            path = suffix % idx
            with open(path, "wb") as f:
                dumper(lines, f)
            out_files.append(path)
            lines = []
            idx += 1
    if lines:
        path = suffix % idx
        with open(path, "wb") as f:
            dumper(lines, f)
        out_files.append(path)
    return out_files


def cluster_files_reader(files_pattern: str, trainer_count: int,
                         trainer_id: int, loader=None):
    """round-robin shard files across trainers (reference: common.py
    cluster_files_reader)."""
    loader = loader or pickle.load

    def reader():
        paths = sorted(_glob.glob(files_pattern))
        for i, path in enumerate(paths):
            if i % trainer_count == trainer_id:
                with open(path, "rb") as f:
                    for item in loader(f):
                        yield item

    return reader


def synthetic_rng(name: str, seed: int = 0) -> np.random.RandomState:
    """The synthetic stream's generator, seeded as the JAX package seeds
    it (from the process's hash of ``(name, seed)``: equal in one process,
    and across processes under one ``PYTHONHASHSEED``)."""
    return np.random.RandomState(abs(hash((name, seed))) % (2 ** 31))


def convert(output_path, reader, line_count, name_prefix):
    """Convert a reader's samples into recordio shard files (reference:
    python/paddle/v2/dataset/common.py convert): every ``line_count``
    samples become one shard ``<output_path>/<name_prefix>-NNNNN`` whose
    records are pickled samples.  Returns the shard paths; read them back
    with ``recordio_reader``."""
    from paddle_tpu_torch.io.recordio import RecordWriter

    assert line_count >= 1
    paths = []
    lines = []

    def flush():
        path = os.path.join(output_path,
                            "%s-%05d" % (name_prefix, len(paths)))
        with RecordWriter(path) as w:
            for item in lines:
                w.write(pickle.dumps(item, protocol=pickle.HIGHEST_PROTOCOL))
        paths.append(path)
        lines.clear()

    for item in reader():
        lines.append(item)
        if len(lines) >= line_count:
            flush()
    if lines:
        flush()
    return paths


def recordio_reader(paths):
    """A reader over shards written by ``convert`` (pickled records)."""
    from paddle_tpu_torch.io.recordio import RecordReader

    def reader():
        for path in paths:
            with RecordReader(path) as r:
                for rec in r:
                    yield pickle.loads(rec)

    return reader
