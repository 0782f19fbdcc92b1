"""Step-level telemetry: metrics registry, span tracing, export sinks,
the executable observatory and distributed request tracing (counterpart
of ``paddle_tpu/observability/``, whose metric catalog and span names the
port keeps).

  * metrics      — thread-safe counters / gauges / µs histograms; one
                   flag check when disabled
  * tracing      — bounded span ring with per-step correlation ids,
                   exported as Chrome trace-event JSON
  * sinks        — JSONL snapshots, Prometheus text, trace files and the
                   ``/metrics`` HTTP surface (``serve_metrics``)
  * executables  — every prepared program with its cost and device time,
                   and the MFU gauges against the card's peaks
  * tracectx     — ``X-Ptpu-Trace`` propagation, span buffers, the trace
                   store and the tail-based flight recorder

Disabled by default; turn on with ``PADDLE_TPU_TELEMETRY=1`` or
``observability.enable()``.  The files each sink writes are the JAX
package's formats, so either package's ``metrics``, ``trace`` and
``executables`` verbs read the other's.

The catalog.  Every metric name of the JAX package whose meaning exists
in the port is registered under the same name and labels: the trainer's
``trainer_*`` (feed, step dispatch, eval, pass, batches, passes, the
padding waste under ``seq_buckets``, the checkpoint hand-off and restore
fallbacks), ``train_loss_scale`` and ``train_skipped_steps_total``; the
prefetcher's ``dataloader_queue_depth`` and ``prefetch_batches_total``;
the checkpoint writer's ``checkpoints_total``,
``checkpoint_quarantined_total``, ``checkpoint_reverified_total`` and
``trainer_checkpoint_save_us`` by phase; Fluid's ``fluid_*``; the serving
engine's ``serving_*`` and ``serving_decode_*``; the router's
``router_*``; the MFU gauges.  Left out, because the port has nothing
they measure:

  * ``fluid_donated_steps_total`` and ``fluid_donation_standdowns_total``:
    XLA's buffer donation (the port's steps rebind or update tensors in
    place; nothing is donated);
  * ``fluid_device_sweeps_total``, ``fluid_device_sweep_skips_total`` and
    ``fluid_device_sweep_retries_total``: JAX's ``device_put`` sweeps
    over a step's arguments (the port copies a feed to its place once);
  * ``fluid_compile_cache_*`` (eleven), ``serving_mesh_slices`` and
    ``serving_slice_rows``: the disk cache of built programs and the mesh
    slices, which wait for items 13b and 14 (``ROADMAP.md`` §1);
  * ``dataloader_batches_total`` and ``dataloader_next_batch_us``: the
    native data loader, item 15 (the gauge ``dataloader_queue_depth`` is
    shared with the prefetcher and registered).

``fluid_compiles_total`` counts the port's builds: a run plan's first
run of a new feed signature, and each ``run_n`` graph captured.
"""

from paddle_tpu_torch.observability import executables
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.observability import sinks
from paddle_tpu_torch.observability import tracectx
from paddle_tpu_torch.observability import tracing
from paddle_tpu_torch.observability.executables import EXECUTABLES
from paddle_tpu_torch.observability.metrics import (
    REGISTRY, counter, disable, enable, enabled, gauge, histogram,
    prometheus_from_snapshot, render_snapshot_table, snapshot_value)
from paddle_tpu_torch.observability.tracing import TRACER, Tracer, span

__all__ = ["metrics", "tracing", "tracectx", "sinks", "executables",
           "EXECUTABLES", "REGISTRY",
           "TRACER", "Tracer",
           "counter", "gauge", "histogram", "span", "enable", "disable",
           "enabled", "reset", "render_table", "snapshot_value",
           "prometheus_from_snapshot", "render_snapshot_table"]


def reset() -> None:
    """Zero every metric and drop every recorded span (handles bound at
    import time stay valid — values reset in place)."""
    REGISTRY.reset()
    TRACER.clear()


def render_table() -> str:
    return REGISTRY.render_table()
