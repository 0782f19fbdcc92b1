"""The recordio framing of the PyTorch port (paddle_tpu_torch/io/recordio.py,
``reader.creator.recordio``, ``dataset.common.convert`` /
``recordio_reader``) against the JAX package's: the same records make the
same bytes in both packages, each reads the other's files, and a damaged
file raises."""

import os

import numpy as np
import pytest

from paddle_tpu.dataset import common as jcommon
from paddle_tpu.io import recordio as jrio
from paddle_tpu.reader import creator as jcreator
from paddle_tpu_torch.dataset import common as tcommon
from paddle_tpu_torch.io import recordio as trio
from paddle_tpu_torch.reader import creator as tcreator

RECORDS = [b"", b"a", bytes(range(256)) * 3,
           np.random.RandomState(0).bytes(70000)]


def _write(mod, path):
    with mod.RecordWriter(str(path)) as w:
        for r in RECORDS:
            w.write(r)


def test_same_bytes_and_cross_reads(tmp_path):
    _write(trio, tmp_path / "port.rio")
    _write(jrio, tmp_path / "jax.rio")
    port = (tmp_path / "port.rio").read_bytes()
    assert port == (tmp_path / "jax.rio").read_bytes()
    assert len(port) == sum(12 + len(r) for r in RECORDS)
    with trio.RecordReader(str(tmp_path / "jax.rio")) as r:
        assert list(r) == RECORDS
    with jrio.RecordReader(str(tmp_path / "port.rio")) as r:
        assert list(r) == RECORDS
    assert trio.RecordReader(str(tmp_path / "jax.rio")).count() == 4
    paths = [str(tmp_path / "port.rio"), str(tmp_path / "jax.rio")]
    assert list(tcreator.recordio(paths)()) == RECORDS * 2
    assert (list(tcreator.recordio(paths[0])())
            == list(jcreator.recordio(paths[0])()))


@pytest.mark.parametrize("damage", ["magic", "crc", "truncated"])
def test_damaged_file_raises(tmp_path, damage):
    path = tmp_path / "d.rio"
    _write(trio, path)
    blob = bytearray(path.read_bytes())
    if damage == "magic":
        blob[0] ^= 0xFF
        match = "bad record magic"
    elif damage == "crc":
        blob[12 + 12] ^= 0xFF             # the second record's payload
        match = "crc mismatch"
    else:
        blob = blob[:-5]
        match = "truncated"
    path.write_bytes(bytes(blob))
    with pytest.raises(IOError, match=match):
        list(trio.RecordReader(str(path)))


def test_convert_and_recordio_reader_cross(tmp_path):
    """``convert`` shards a reader's samples, ``line_count`` a shard, as
    pickled records: the shard files equal the JAX package's byte for
    byte, and each package's ``recordio_reader`` reads them back."""
    samples = [(np.arange(i, dtype=np.float32), i % 3, f"s{i}")
               for i in range(7)]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    tpaths = tcommon.convert(str(tmp_path / "port"), lambda: iter(samples),
                             3, "train")
    jpaths = jcommon.convert(str(tmp_path / "jax"), lambda: iter(samples),
                             3, "train")
    assert [os.path.basename(p) for p in tpaths] == [
        "train-00000", "train-00001", "train-00002"]
    assert ([os.path.basename(p) for p in tpaths]
            == [os.path.basename(p) for p in jpaths])
    for tp, jp in zip(tpaths, jpaths):
        with open(tp, "rb") as a, open(jp, "rb") as b:
            assert a.read() == b.read()
    for got in (list(tcommon.recordio_reader(jpaths)()),
                list(jcommon.recordio_reader(tpaths)())):
        assert len(got) == 7
        for (x, y, s), (wx, wy, ws) in zip(got, samples):
            np.testing.assert_array_equal(x, wx)
            assert (y, s) == (wy, ws)
