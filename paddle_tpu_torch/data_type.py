"""Input type declarations for data layers and feeders (the port's copy of
``paddle_tpu/data_type.py``).

Reference: python/paddle/trainer/PyDataProvider2.py input_types —
dense_vector / sparse_binary_vector / sparse_float_vector / integer_value and
their *_sequence variants, re-exported by python/paddle/v2/data_type.py.

Sequences are padded to bucket lengths with an explicit length field;
sparse vectors are packed to a fixed number of (id, value) slots
(``nnz``).  The port declares every type; its Topology refuses nested
sequences for now.
"""

from __future__ import annotations

import dataclasses


class DataKind:
    DENSE = "dense"
    SPARSE_BINARY = "sparse_binary"
    SPARSE_FLOAT = "sparse_float"
    INDEX = "index"


class SeqType:
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


@dataclasses.dataclass(frozen=True)
class InputType:
    dim: int
    kind: str
    seq_type: int = SeqType.NO_SEQUENCE
    # static-shape knobs for the TPU feed path:
    max_len: int = 0        # pad/bucket length for sequences
    nnz: int = 0            # fixed slots for sparse encodings
    sub_max: int = 0        # outer length for nested (sub-)sequences


def dense_vector(dim, seq_type=SeqType.NO_SEQUENCE, max_len=0):
    return InputType(dim, DataKind.DENSE, seq_type, max_len=max_len)


def sparse_binary_vector(dim, seq_type=SeqType.NO_SEQUENCE, nnz=64, max_len=0):
    return InputType(dim, DataKind.SPARSE_BINARY, seq_type, max_len=max_len, nnz=nnz)


def sparse_float_vector(dim, seq_type=SeqType.NO_SEQUENCE, nnz=64, max_len=0):
    return InputType(dim, DataKind.SPARSE_FLOAT, seq_type, max_len=max_len, nnz=nnz)


def integer_value(value_range, seq_type=SeqType.NO_SEQUENCE, max_len=0):
    return InputType(value_range, DataKind.INDEX, seq_type, max_len=max_len)


def dense_vector_sequence(dim, max_len=0):
    return dense_vector(dim, SeqType.SEQUENCE, max_len=max_len)


def dense_vector_sub_sequence(dim, sub_max=0, max_len=0):
    """Nested sequence of dense vectors: feed [B, S, T, dim] plus
    `@len` [B] (outer #subsequences) and `@sublen` [B, S] (inner
    lengths). Reference: dense_vector_sub_sequence in PyDataProvider2."""
    return InputType(dim, DataKind.DENSE, SeqType.SUB_SEQUENCE,
                     max_len=max_len, sub_max=sub_max)


def integer_value_sub_sequence(value_range, sub_max=0, max_len=0):
    """Nested sequence of ids: feed [B, S, T] (+ @len / @sublen)."""
    return InputType(value_range, DataKind.INDEX, SeqType.SUB_SEQUENCE,
                     max_len=max_len, sub_max=sub_max)


def integer_value_sequence(value_range, max_len=0):
    return integer_value(value_range, SeqType.SEQUENCE, max_len=max_len)


def sparse_binary_vector_sequence(dim, nnz=64, max_len=0):
    return sparse_binary_vector(dim, SeqType.SEQUENCE, nnz=nnz, max_len=max_len)
