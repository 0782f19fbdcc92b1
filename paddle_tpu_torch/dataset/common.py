"""Shared dataset plumbing (counterpart of ``paddle_tpu/dataset/common.py``;
reference: v2/dataset/common.py): the cache directory, file splitting and
sharding for several trainers, and the seeded generator of the synthetic
streams.

Not ported yet, and refused: ``convert`` and ``recordio_reader``, which
write and read the record files of ``io/recordio.py`` (``ROADMAP.md``
section 1, item 6).
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
    raise NotImplementedError(
        "dataset.common.convert is not ported to paddle_tpu_torch yet "
        "(ROADMAP.md section 1, item 6)")


def recordio_reader(paths):
    raise NotImplementedError(
        "dataset.common.recordio_reader is not ported to paddle_tpu_torch "
        "yet (ROADMAP.md section 1, item 6)")
