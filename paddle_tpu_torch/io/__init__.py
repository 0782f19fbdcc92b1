"""IO: checkpoints (``io/checkpoint.py``), crash-safe writes
(``io/atomic.py``) and recordio shard files (``io/recordio.py``)."""

from paddle_tpu_torch.io.recordio import RecordReader, RecordWriter
