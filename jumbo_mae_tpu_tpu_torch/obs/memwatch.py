"""Memory observability: live card and host telemetry, byte accounting, leaks.

Counterpart of ``jumbo_mae_tpu_tpu/obs/memwatch.py``, the same gauges,
snapshots, verdicts and refusals. The card's side reads PyTorch's caching
allocator where the JAX module reads ``device.memory_stats()``:

- :class:`MemoryWatcher` samples the card through
  ``torch.cuda.memory_stats(device)`` (``allocated_bytes.all.current`` and
  ``allocated_bytes.all.peak``) plus host RSS and the Python allocator's
  live block count, publishing ``mem_device_bytes{device="cuda:<i>"}``,
  ``mem_device_peak_bytes{device=}``, ``mem_host_rss_bytes`` and
  ``mem_py_alloc_blocks``. A watcher built for ``device="cpu"`` degrades
  as the JAX one does on XLA:CPU: the device and drift gauges are *never
  registered* (absent from the scrape, not zero) and the first sample
  carries a one-shot ``note``. A watcher built for ``"cuda"`` has no such
  fallback: a stats read that fails raises.
- The watcher checks the capacity model: feed it the predicted peak of
  each captured graph (``record_predicted_peak``, from
  ``ProgramCost.peak_bytes``) and every sample publishes
  ``mem_hbm_predict_vs_measured{program=}`` = measured peak / predicted
  peak.
- :class:`MemAccountant` is one registry for byte accounting of the
  in-process caches and buffers (the engines' encoder LRUs and captured
  graph pools, the warm cache's directory, the batcher's queue),
  publishing ``mem_component_bytes{component=}``.
- :class:`LeakSentinel` fits a robust (Theil–Sen) slope over a rolling
  window of RSS and per-component samples; sustained growth names the
  fastest-growing component and latches degraded.
- :meth:`MemoryWatcher.headroom_check` is the weight swap's memory gate.
  The JAX check asks whether the swap's double buffer (the restored tree
  and the snapshot of the live one) fits the host's ``MemAvailable``. The
  port's swap also builds each served model aside on the card before it
  copies, so the same check also holds those bytes against
  ``torch.cuda.mem_get_info`` on the watcher's card; the refusal names
  the memory that is short.
- ``tools/mem_doctor.py`` turns journaled ``mem_sample`` rows into the
  offline diagnosis.
- :func:`fix_mmap_threshold` makes the resident set follow the live host
  memory (the train CLI calls it), so that what the sentinel reads as
  growth is memory something holds.

Sampling is scrape-rate work, never per dispatch: one
``/proc/self/status`` read, one ``memory_stats`` call, and one cheap
probe per registered component. torch is imported where the card is
read, so ``obs`` imports in the data workers' interpreters, which never
import torch.
"""

from __future__ import annotations

import ctypes
import sys
import threading
import time
from collections import deque
from collections.abc import Mapping
from typing import Callable

from jumbo_mae_tpu_tpu_torch.obs.metrics import get_registry

MB = 1024 * 1024
M_MMAP_THRESHOLD = -3  # glibc's mallopt parameter number


# --------------------------------------------------------------- host probes


def host_rss_bytes() -> int | None:
    """Current resident set size from ``/proc/self/status`` (Linux).

    Falls back to ``ru_maxrss`` (the *peak* RSS, still monotone under a
    leak, so the sentinel keeps working) where /proc is missing; ``None``
    when neither source exists.
    """
    try:
        with open("/proc/self/status", "rb") as f:
            for line in f:
                if line.startswith(b"VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return None


def fix_mmap_threshold(nbytes: int = MB) -> bool:
    """Serve every host allocation of ``nbytes`` or more by a mapping of
    its own, unmapped when freed: glibc's ``mallopt(M_MMAP_THRESHOLD)``,
    as the ``MALLOC_MMAP_THRESHOLD_`` variable would set it. By default
    glibc raises the threshold to the largest block freed so far (up to 32
    MiB), so after the first one every later block of that size (a train
    batch of 18.4 MiB at 128 × 224 × 224 × 3, a 16-MiB weight) comes from
    an arena and stays resident after it is freed: the resident set then
    grows for tens of steps with nothing alive in it, which the leak
    sentinel can only call ``unaccounted``. Process-wide and not undone.
    Returns whether the C library took it (False without glibc's
    ``mallopt``)."""
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes, mallopt.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return mallopt(M_MMAP_THRESHOLD, int(nbytes)) == 1


def host_available_bytes() -> int | None:
    """``MemAvailable`` from ``/proc/meminfo``: the kernel's estimate of
    how much can be allocated without swapping; ``None`` off Linux."""
    try:
        with open("/proc/meminfo", "rb") as f:
            for line in f:
                if line.startswith(b"MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


def tree_nbytes(tree) -> int:
    """Total array bytes of a tree of mappings, lists and tuples: a tensor
    counts ``numel × element_size``, anything else with ``.nbytes`` (numpy
    arrays) that; other leaves (scalars, None) count zero."""
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if hasattr(x, "element_size") and hasattr(x, "numel"):  # a tensor
            total += x.numel() * x.element_size()
        elif isinstance(x, Mapping):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        else:
            total += int(getattr(x, "nbytes", 0) or 0)
    return total


def device_label(device) -> str:
    """``cuda:<index>`` (the current device's index when none is named)."""
    import torch

    index = device.index if device.index is not None else torch.cuda.current_device()
    return f"{device.type}:{index}"


def _device_memory_stats(device) -> list[tuple[str, int | None, int | None]] | None:
    """``[(label, allocated bytes, peak allocated bytes)]`` of the card;
    ``None`` for a CPU watcher (host-only telemetry). On the card a failed
    read raises: it never degrades to host-only."""
    if device.type != "cuda":
        return None
    import torch

    stats = torch.cuda.memory_stats(device)
    # an allocator that has not allocated yet reports no byte counters
    return [(device_label(device), int(stats.get("allocated_bytes.all.current", 0)),
             int(stats.get("allocated_bytes.all.peak", 0)))]


def _theil_sen_slope(values) -> float:
    """Median pairwise slope per *sample index*: robust to one-off jumps
    (an eval allocating a temporary buffer) that would swing a
    least-squares fit; O(n²) pairs on a window-sized input."""
    n = len(values)
    if n < 2:
        return 0.0
    slopes = [(values[j] - values[i]) / (j - i) for i in range(n) for j in range(i + 1, n)]
    slopes.sort()
    m = len(slopes)
    mid = m // 2
    if m % 2:
        return float(slopes[mid])
    return float(slopes[mid - 1] + slopes[mid]) / 2.0


# ----------------------------------------------------------- MemAccountant


class MemAccountant:
    """One registry for byte accounting of every in-process cache/buffer.

    Components register a zero-arg probe returning their current byte
    footprint (or ``None`` while unknowable); :meth:`sample` polls every
    probe and publishes ``mem_component_bytes{component=}``. Probes must
    be cheap (a counter read, a ``stat()``): they run per scrape. A probe
    that raises is skipped for that sample, never fatal.
    """

    def __init__(self, registry=None):
        reg = registry if registry is not None else get_registry()
        self._g = reg.gauge(
            "mem_component_bytes",
            "live byte accounting per in-process cache/buffer",
            labels=("component",),
        )
        self._probes: dict[str, Callable[[], float | None]] = {}
        self._lock = threading.Lock()

    def register(self, component: str, probe: Callable[[], float | None]):
        with self._lock:
            self._probes[component] = probe

    def unregister(self, component: str):
        with self._lock:
            self._probes.pop(component, None)

    def components(self) -> list[str]:
        with self._lock:
            return sorted(self._probes)

    def sample(self) -> dict[str, int]:
        with self._lock:
            probes = list(self._probes.items())
        out: dict[str, int] = {}
        for name, probe in probes:
            try:
                v = probe()
            except Exception:
                continue
            if v is None:
                continue
            out[name] = int(v)
            self._g.labels(component=name).set(float(v))
        return out


# ---------------------------------------------------------- MemoryWatcher


class MemoryWatcher:
    """Samples the card's and the host's memory and checks the predicted
    peaks.

    Host gauges (``mem_host_rss_bytes``, ``mem_py_alloc_blocks``) register
    at construction. The card's gauges (``mem_device_bytes``,
    ``mem_device_peak_bytes``) and the drift gauge
    (``mem_hbm_predict_vs_measured``) register at the first card sample,
    so a CPU watcher's scrape does not carry them. ``device`` is the card
    the served engines run on (``"cuda"``, ``"cuda:<i>"``) or ``"cpu"``.
    """

    def __init__(self, *, accountant: MemAccountant | None = None, registry=None, chip=None, device="cuda"):
        import torch

        reg = registry if registry is not None else get_registry()
        self._reg = reg
        self.accountant = accountant
        self.device = torch.device(device)
        # chip: obs.perfmodel.ChipSpec | None, the card's memory capacity
        # the doctor's OOM-risk estimate divides by (0 on the generic CPU)
        self.chip = chip
        self._g_rss = reg.gauge("mem_host_rss_bytes", "host resident set size of this process")
        self._g_blocks = reg.gauge(
            "mem_py_alloc_blocks",
            "live Python allocator blocks (sys.getallocatedblocks) — a unit-free heap-growth signal",
        )
        self._g_dev = None
        self._g_dev_peak = None
        self._g_drift = None
        self._predicted: dict[str, float] = {}
        self._lock = threading.Lock()
        self._device_degraded = False
        self._degrade_noted = False
        self._last: dict = {}

    # -- prediction side of the drift gauge ------------------------------

    def record_predicted_peak(self, program: str, peak_bytes) -> None:
        """Attach the capacity model's peak for ``program`` (an engine's
        ``task/b<bucket>`` graph); every later sample publishes measured
        / predicted for it. Zero or None predictions are ignored."""
        try:
            v = float(peak_bytes or 0)
        except (TypeError, ValueError):
            return
        if v > 0:
            with self._lock:
                self._predicted[program] = v

    def predicted_peaks(self) -> dict[str, float]:
        with self._lock:
            return dict(self._predicted)

    # -- sampling ---------------------------------------------------------

    def sample(self) -> dict:
        """One telemetry sample; publishes the gauges and returns the
        snapshot dict a caller can journal as a ``mem_sample`` event.
        Usable directly as a ``TelemetryServer.add_pre_scrape`` hook."""
        snap: dict = {"ts": time.time()}
        rss = host_rss_bytes()
        if rss is not None:
            self._g_rss.set(float(rss))
            snap["rss_bytes"] = int(rss)
        blocks = sys.getallocatedblocks()
        self._g_blocks.set(float(blocks))
        snap["py_alloc_blocks"] = int(blocks)

        dev = _device_memory_stats(self.device)
        if dev is None:
            self._device_degraded = True
            if not self._degrade_noted:
                self._degrade_noted = True
                snap["note"] = (
                    "device memory_stats() unavailable on this backend — HBM gauges degraded to host-only telemetry"
                )
        else:
            self._device_degraded = False
            if self._g_dev is None:
                self._g_dev = self._reg.gauge("mem_device_bytes", "live device (HBM) bytes in use", labels=("device",))
                self._g_dev_peak = self._reg.gauge(
                    "mem_device_peak_bytes", "high-water device (HBM) bytes since process start", labels=("device",)
                )
            peak_max = 0
            in_use_total = 0
            for label, in_use, peak in dev:
                if in_use is not None:
                    self._g_dev.labels(device=label).set(float(in_use))
                    in_use_total += int(in_use)
                if peak is not None:
                    self._g_dev_peak.labels(device=label).set(float(peak))
                    peak_max = max(peak_max, int(peak))
            snap["device_bytes"] = int(in_use_total)
            snap["device_peak_bytes"] = int(peak_max)
            drift = self._publish_drift(peak_max)
            if drift:
                snap["hbm_drift"] = drift
        if self.chip is not None and getattr(self.chip, "hbm_bytes", 0):
            snap["hbm_capacity_bytes"] = int(self.chip.hbm_bytes)
        if self.accountant is not None:
            comps = self.accountant.sample()
            if comps:
                snap["components"] = comps
        self._last = snap
        return snap

    def _publish_drift(self, measured_peak: int) -> dict[str, float]:
        if measured_peak <= 0:
            return {}
        with self._lock:
            predicted = dict(self._predicted)
        if not predicted:
            return {}
        if self._g_drift is None:
            self._g_drift = self._reg.gauge(
                "mem_hbm_predict_vs_measured",
                "measured device peak bytes / capacity-model predicted peak, per active executable (>1 = model "
                "under-predicts)",
                labels=("program",),
            )
        out: dict[str, float] = {}
        for program, pred in predicted.items():
            ratio = round(measured_peak / pred, 4)
            self._g_drift.labels(program=program).set(ratio)
            out[program] = ratio
        return out

    # -- readouts ---------------------------------------------------------

    @property
    def device_stats_degraded(self) -> bool:
        return self._device_degraded

    def last_sample(self) -> dict:
        """Most recent snapshot, shaped for ``HealthState.probe()``."""
        return self._last

    def headroom_check(self, need_bytes: int, device_bytes: int = 0, *, margin_frac: float = 0.10) -> str | None:
        """``None`` when ``need_bytes`` fits in the host's available memory
        and ``device_bytes`` in the card's free memory, each with
        ``margin_frac`` slack; otherwise the refusal, naming the memory that
        is short. Unknowable host headroom (no /proc/meminfo) is not a
        refusal; a watcher built for the CPU checks no card."""
        avail = host_available_bytes()
        if avail is not None:
            budget = int(avail * (1.0 - margin_frac))
            if int(need_bytes) > budget:
                return (
                    f"needs {int(need_bytes) // MB} MiB but only {budget // MB} MiB of host memory is safely "
                    f"available (MemAvailable {avail // MB} MiB, {margin_frac:.0%} margin)"
                )
        if int(device_bytes) > 0 and self.device.type == "cuda":
            import torch

            free, total = torch.cuda.mem_get_info(self.device)
            budget = int(free * (1.0 - margin_frac))
            if int(device_bytes) > budget:
                return (
                    f"needs {int(device_bytes) // MB} MiB but only {budget // MB} MiB of card memory on "
                    f"{device_label(self.device)} is safely available (free {free // MB} MiB of {total // MB} MiB, "
                    f"{margin_frac:.0%} margin)"
                )
        return None


# ----------------------------------------------------------- LeakSentinel


class LeakSentinel:
    """Names the fastest-growing component under sustained RSS growth.

    Feed it every :meth:`MemoryWatcher.sample` snapshot. Over a rolling
    window it fits a Theil–Sen slope to RSS *per sample*; when the robust
    growth across the window exceeds ``min_growth_mb`` it fires **once**
    (latched: ``/healthz`` stays degraded for the rest of the run) and
    returns the suspect dict for the caller to journal as
    ``mem_leak_suspect``. The suspect is the registered component with the
    largest robust slope; when no component explains the growth the
    verdict is ``unaccounted`` (native or allocator memory outside the
    accountant's reach).
    """

    def __init__(self, *, window: int = 12, min_samples: int = 4, min_growth_mb: float = 32.0, registry=None):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.window = int(window)
        self.min_samples = max(2, int(min_samples))
        self.min_growth_bytes = float(min_growth_mb) * MB
        self._reg = registry if registry is not None else get_registry()
        self._g_suspect = None
        self._samples: deque = deque(maxlen=self.window)
        self._fired: dict | None = None

    def degraded(self) -> bool:
        """Latched verdict, for ``HealthState.degraded_when``."""
        return self._fired is not None

    @property
    def suspect(self) -> dict | None:
        return self._fired

    def observe(self, snap: dict) -> dict | None:
        """Account one snapshot; returns the suspect dict on the single
        firing transition, ``None`` otherwise (including while latched)."""
        rss = snap.get("rss_bytes")
        if rss is None:
            return None
        self._samples.append((float(snap.get("ts", 0.0)), int(rss), dict(snap.get("components") or {})))
        if self._fired is not None or len(self._samples) < self.min_samples:
            return None
        rss_series = [s[1] for s in self._samples]
        slope = _theil_sen_slope(rss_series)
        n = len(rss_series)
        robust_growth = slope * (n - 1)
        if robust_growth < self.min_growth_bytes:
            return None
        suspect, comp_slope = "unaccounted", 0.0
        names = set()
        for _, _, comps in self._samples:
            names.update(comps)
        for name in sorted(names):
            s = _theil_sen_slope([smp[2].get(name, 0) for smp in self._samples])
            if s > comp_slope:
                suspect, comp_slope = name, s
        # a component takes the blame only when its growth is a real share
        # of the RSS growth
        if suspect != "unaccounted" and comp_slope < 0.2 * slope:
            suspect, comp_slope = "unaccounted", 0.0
        span_s = self._samples[-1][0] - self._samples[0][0]
        self._fired = {
            "component": suspect,
            "rss_growth_bytes": int(rss_series[-1] - rss_series[0]),
            "robust_growth_bytes": int(robust_growth),
            "slope_bytes_per_sample": int(slope),
            "component_slope_bytes_per_sample": int(comp_slope),
            "window": n,
            "window_span_s": round(max(span_s, 0.0), 3),
        }
        if self._g_suspect is None:
            self._g_suspect = self._reg.gauge(
                "mem_leak_suspect",
                "1 once the leak sentinel latched, naming the fastest-growing component",
                labels=("component",),
            )
        self._g_suspect.labels(component=suspect).set(1.0)
        return dict(self._fired)
