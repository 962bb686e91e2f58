"""The port's observability; each module mirrors ``jumbo_mae_tpu_tpu/obs``.

- ``obs.metrics``: counters, gauges, histograms, the Prometheus text;
- ``obs.exporter``: the stdlib HTTP server of ``/metrics`` and ``/healthz``;
- ``obs.slo``: SLO objectives, burn rates, the degraded flag, ``slo_*``;
- ``obs.memwatch``: card and host memory gauges, byte accounting, the
  leak sentinel and the weight swap's headroom check;
- ``obs.retrace``: the capture sentinel (no new CUDA graph after warmup);
- ``obs.trace``: host spans into ``span_seconds``, the chrome trace, and
  ``torch.profiler`` captures (``trace``, ``annotate``);
- ``obs.flightrec``: the crash flight recorder (ring + black-box dumps);
- ``obs.hangwatch``: the step-deadline hang watchdog (``EXIT_HANG``);
- ``obs.goodput``: the wall-clock attribution ledger, cross-generation
  stitching and the checkpoint-interval advisor;
- ``obs.lockwatch``: opt-in instrumented locks (``GRAFT_LOCKWATCH=1``);
- ``obs.modelstats``: per-layer-group grad/param/update statistics
  computed in the train step (``diag=True``), their gauges and journal
  shape;
- ``obs.perfledger``: the schema-versioned ``BENCH_HISTORY.jsonl``
  writer and reader;
- ``obs.reqtrace``, ``obs.journal``, ``obs.costmodel``, ``obs.perfmodel``,
  ``obs.mfu``, ``obs.doctor_common``.

Re-exported here as the JAX package's ``obs/__init__.py`` does.
"""

from jumbo_mae_tpu_tpu_torch.obs.costmodel import (
    COST_SCHEMA_VERSION,
    ProgramCost,
    UtilizationReport,
    cost_asdict,
    program_cost,
    publish_cost,
    train_step_cost,
    train_step_flops,
    utilization_report,
)
from jumbo_mae_tpu_tpu_torch.obs.exporter import HealthState, TelemetryServer
from jumbo_mae_tpu_tpu_torch.obs.flightrec import FlightRecorder
from jumbo_mae_tpu_tpu_torch.obs.goodput import (
    GOODPUT_BUCKETS,
    GoodputLedger,
    advise_ckpt_interval,
    bucket_display,
    stitch_generations,
)
from jumbo_mae_tpu_tpu_torch.obs.hangwatch import HangWatchdog
from jumbo_mae_tpu_tpu_torch.obs.lockwatch import WatchedLock
from jumbo_mae_tpu_tpu_torch.obs.memwatch import (
    LeakSentinel,
    MemAccountant,
    MemoryWatcher,
    host_available_bytes,
    host_rss_bytes,
    tree_nbytes,
)
from jumbo_mae_tpu_tpu_torch.obs.metrics import (
    LATENCY_BUCKETS,
    NULL_REGISTRY,
    RATIO_BUCKETS,
    Counter,
    Family,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    get_registry,
    set_registry,
)
from jumbo_mae_tpu_tpu_torch.obs.modelstats import (
    STAT_NAMES,
    first_nonfinite_group,
    group_layout,
    group_of,
    group_stats,
    publish_group_stats,
    stats_dict,
)
from jumbo_mae_tpu_tpu_torch.obs.perfledger import (
    LEDGER_SCHEMA,
    append_row,
    comparable_env,
    make_row,
    read_ledger,
    resolve_history_path,
)
from jumbo_mae_tpu_tpu_torch.obs.perfmodel import (
    ChipSpec,
    PerfPrediction,
    chip_spec,
    detect_chip,
    dp_comm_bytes,
    fsdp_comm_bytes,
    predict_train_step,
    publish_drift,
    roofline,
)
from jumbo_mae_tpu_tpu_torch.obs.reqtrace import OUTCOMES, AccessLog, RequestTrace, RequestTracer
from jumbo_mae_tpu_tpu_torch.obs.retrace import RetraceSentinel
from jumbo_mae_tpu_tpu_torch.obs.slo import SLOObjective, SLOTracker, parse_slo
from jumbo_mae_tpu_tpu_torch.obs.trace import (
    annotate,
    export_chrome_trace,
    span,
    span_timer,
    start_chrome_trace,
    stop_chrome_trace,
    trace,
)

__all__ = [
    "AccessLog",
    "COST_SCHEMA_VERSION",
    "ChipSpec",
    "Counter",
    "Family",
    "FlightRecorder",
    "GOODPUT_BUCKETS",
    "Gauge",
    "GoodputLedger",
    "HangWatchdog",
    "HealthState",
    "Histogram",
    "LATENCY_BUCKETS",
    "LEDGER_SCHEMA",
    "LeakSentinel",
    "MemAccountant",
    "MemoryWatcher",
    "MetricsRegistry",
    "NULL_REGISTRY",
    "NullRegistry",
    "OUTCOMES",
    "PerfPrediction",
    "ProgramCost",
    "RATIO_BUCKETS",
    "RequestTrace",
    "RequestTracer",
    "RetraceSentinel",
    "SLOObjective",
    "SLOTracker",
    "STAT_NAMES",
    "TelemetryServer",
    "UtilizationReport",
    "WatchedLock",
    "advise_ckpt_interval",
    "annotate",
    "append_row",
    "bucket_display",
    "chip_spec",
    "comparable_env",
    "cost_asdict",
    "detect_chip",
    "dp_comm_bytes",
    "export_chrome_trace",
    "first_nonfinite_group",
    "fsdp_comm_bytes",
    "get_registry",
    "group_layout",
    "group_of",
    "group_stats",
    "host_available_bytes",
    "host_rss_bytes",
    "make_row",
    "parse_slo",
    "predict_train_step",
    "program_cost",
    "publish_cost",
    "publish_drift",
    "publish_group_stats",
    "read_ledger",
    "resolve_history_path",
    "roofline",
    "set_registry",
    "span",
    "span_timer",
    "start_chrome_trace",
    "stats_dict",
    "stitch_generations",
    "stop_chrome_trace",
    "trace",
    "train_step_cost",
    "train_step_flops",
    "tree_nbytes",
    "utilization_report",
]
