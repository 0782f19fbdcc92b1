"""PyDataProvider2 compatibility: the @provider decorator + data sources.

Reference: python/paddle/trainer/PyDataProvider2.py (provider decorator
:365, input_types, settings object, cache/shuffle knobs) and
python/paddle/trainer_config_helpers/data_sources.py
(define_py_data_sources2). Legacy configs declare their data pipeline as

    @provider(input_types={'data': integer_value_sequence(V),
                           'label': integer_value(2)})
    def process(settings, file_name):
        ...
        yield {...} / tuple

    define_py_data_sources2("train.list", "test.list",
                            module="provider_module", obj="process",
                            args={...})

The reference runs the provider in an embedded CPython inside a C++
background pool (PyDataProvider2.cpp loadThread).  Here the provider
becomes a plain reader (callable -> iterator) feeding the train step;
background prefetch is reader/prefetch.py's job.  A copy of
``paddle_tpu/py_data_provider2.py`` (stdlib only).
The shuffle pool (`pool_size`/`min_pool_size`) maps to
reader.decorator.shuffle's buffer; CacheType.CACHE_PASS_IN_MEM caches
decoded samples after the first pass.
"""

from __future__ import annotations

import functools
import importlib
import os
import random
from typing import Optional

from paddle_tpu_torch import data_type


class SequenceType:
    NO_SEQUENCE = 0
    SEQUENCE = 1
    SUB_SEQUENCE = 2


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


# legacy input-type constructors re-exported (reference declares its own
# twins of the trainer_config_helpers types)
dense_vector = data_type.dense_vector
dense_vector_sequence = data_type.dense_vector_sequence
integer_value = data_type.integer_value
integer_value_sequence = data_type.integer_value_sequence
sparse_binary_vector = getattr(data_type, "sparse_binary_vector", None)
sparse_float_vector = getattr(data_type, "sparse_float_vector", None)


class _Settings:
    """the `settings` object handed to the decorated function
    (reference: PyDataProvider2 settings — carries input_types + user
    attrs set by init_hook)."""

    def __init__(self, input_types, is_train, file_list, args):
        self.input_types = input_types
        self.is_train = is_train
        self.file_list = file_list
        self.args = args or {}
        self.logger = __import__("logging").getLogger("paddle_tpu_torch.provider")


class DataProviderWrapper:
    """callable → reader factory produced by @provider."""

    def __init__(self, fn, input_types, should_shuffle, pool_size,
                 min_pool_size, cache, init_hook, calc_batch_size=None,
                 can_over_batch_size=True):
        self.calc_batch_size = calc_batch_size
        self.can_over_batch_size = can_over_batch_size
        self.fn = fn
        self.input_types = input_types
        self.should_shuffle = should_shuffle
        self.pool_size = pool_size
        self.min_pool_size = min_pool_size
        self.cache = cache
        self.init_hook = init_hook
        self._cached: dict = {}        # per-(file list) pass cache
        functools.update_wrapper(self, fn)

    def feeding(self):
        """{layer_name: column} when input_types is a dict, else None
        (tuple samples feed positionally)."""
        if isinstance(self.input_types, dict):
            return {k: i for i, k in enumerate(self.input_types)}
        return None

    def reader(self, file_list, is_train=True, args=None, seed=0):
        """build a reader over the file list (reference: one embedded
        interpreter call per file inside loadThread)."""
        if isinstance(file_list, str):
            with open(file_list) as f:
                files = [ln.strip() for ln in f if ln.strip()]
        else:
            files = list(file_list or [None])

        settings = _Settings(self.input_types, is_train, files, args)
        if self.init_hook is not None:
            self.init_hook(settings, file_list=files, is_train=is_train,
                           **(args or {}))

        def normalize(sample):
            if isinstance(sample, dict) and isinstance(self.input_types,
                                                       dict):
                return tuple(sample[k] for k in self.input_types)
            return sample

        def raw():
            for fname in files:
                for sample in self.fn(settings, fname):
                    yield normalize(sample)

        cache_key = (tuple(files), bool(is_train))

        def cached():
            if cache_key not in self._cached:
                self._cached[cache_key] = list(raw())
            return iter(self._cached[cache_key])

        base = cached if self.cache == CacheType.CACHE_PASS_IN_MEM else raw
        shuffle = (self.should_shuffle if self.should_shuffle is not None
                   else is_train)
        if not shuffle:
            return base
        buf = self.pool_size if self.pool_size > 0 else 2048

        def shuffled():
            from paddle_tpu_torch.reader.decorator import shuffle as shuf
            return shuf(base, buf)()

        return shuffled

    def __call__(self, *a, **kw):
        return self.fn(*a, **kw)


def provider(input_types=None, should_shuffle=None, pool_size=-1,
             min_pool_size=-1, can_over_batch_size=True,
             calc_batch_size=None, cache=CacheType.NO_CACHE, check=False,
             check_fail_continue=False, init_hook=None, **outer_kwargs):
    """reference: PyDataProvider2.py:365. calc_batch_size prices each
    sample (variable-cost batching, PyDataProvider2.cpp:280-294); the
    CLI's batch assembly honors it via reader.batched. check is accepted
    for source compatibility."""

    def wrap(fn):
        return DataProviderWrapper(fn, input_types, should_shuffle,
                                   pool_size, min_pool_size, cache,
                                   init_hook,
                                   calc_batch_size=calc_batch_size,
                                   can_over_batch_size=can_over_batch_size)

    return wrap


# ------------------------------------------------------- data sources
# module-level registry the CLI reads (reference: define_py_data_sources2
# writes the provider config into the global trainer proto)
_SOURCES: dict = {}


def define_py_data_sources2(train_list, test_list, module, obj, args=None):
    """reference: trainer_config_helpers/data_sources.py:define_py_data_
    sources2 — registers train/test providers for `paddle train --config`."""
    mod = importlib.import_module(module) if isinstance(module, str) \
        else module
    prov = getattr(mod, obj) if isinstance(obj, str) else obj
    _SOURCES.clear()
    _SOURCES.update(train_list=train_list, test_list=test_list,
                    provider=prov, args=args)


def get_data_sources() -> Optional[dict]:
    return dict(_SOURCES) if _SOURCES else None
