"""recordio: length-prefixed framed record files with a CRC (counterpart
of ``paddle_tpu/io/recordio.py``; the same bytes both ways).

Format (little-endian): per record ``[u32 magic][u32 len][u32 crc32]
[bytes]``.  The framing is flat: compression is left to the payload's
producer.  The JAX package's C++ twin that counts records
(``native/src/recordio.cc``) is not ported yet (``ROADMAP.md`` section 1,
item 15): ``RecordReader.count`` reads the records in Python.
"""

from __future__ import annotations

import struct
import zlib

_MAGIC = 0x50545255  # "PTRU"
_HEADER = struct.Struct("<III")


class RecordWriter:
    def __init__(self, path: str):
        self._f = open(path, "wb")

    def write(self, data: bytes) -> None:
        crc = zlib.crc32(data) & 0xFFFFFFFF
        self._f.write(_HEADER.pack(_MAGIC, len(data), crc))
        self._f.write(data)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordReader:
    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")

    def __iter__(self):
        while True:
            head = self._f.read(_HEADER.size)
            if len(head) < _HEADER.size:
                break
            magic, length, crc = _HEADER.unpack(head)
            if magic != _MAGIC:
                raise IOError(f"{self.path}: bad record magic {magic:#x}")
            data = self._f.read(length)
            if len(data) != length:
                raise IOError(f"{self.path}: truncated record")
            if (zlib.crc32(data) & 0xFFFFFFFF) != crc:
                raise IOError(f"{self.path}: crc mismatch")
            yield data

    def count(self) -> int:
        with RecordReader(self.path) as r:
            return sum(1 for _ in r)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
