"""Utilities: the profiler bridge and the runtime lock-order checker."""
