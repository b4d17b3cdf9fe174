"""Memory monitoring: host RSS sampling thread + device memory stats.

Counterpart of sorting_fhe_tpu/utils/memory.py, a rebuild of the
reference's tests/memory_tracker.{h,cpp}: a background thread samples
/proc/self/status VmRSS every `interval` seconds, tracking the peak and
the running average (memory_tracker.cpp:8-98 samples at 500 ms with a
CAS-updated peak).  The host sampler is a copy.

On a CUDA device the monitor also reads torch.cuda.memory_allocated and
max_memory_allocated of its device at start, at each mark and at stop,
resetting the device's peak counter at each of them, so that every
device peak belongs to one phase.  Those numbers go under their own
keys (device_*), beside the reference's host keys: the JAX package's
report() puts its device peak under the host's `peak_gb`, so its "Peak
Memory" mixes a device peak with host idle and setup numbers.  On any
other device there are no device keys.

Usage (the reference's idle/setup/peak protocol,
tests/DirectSortTest.cpp:125-185):

    mon = MemoryMonitor(device=ctx.device).start()   # idle baseline
    ... build context/keys ...
    mon.mark("setup")
    ... sort ...
    mon.stop()
    report = mon.report()       # idle/setup/peak/avg + overheads (host),
                                # device_* per phase (CUDA only)
"""

from __future__ import annotations

import threading

import torch


def host_rss_gb() -> float:
    """VmRSS of this process in GB (Linux; 0.0 where unsupported)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024.0 / 1024.0
    except OSError:
        pass
    return 0.0


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def device_mem_gb(device, unit: float = 2 ** 30) -> dict[str, float]:
    """Allocated bytes of a CUDA device now and at their peak since the
    last reset_device_peak, in `unit` bytes (default 2^30, as the JAX
    package's monitor; bench.py reports 10^9); empty for any other
    device."""
    if not _is_cuda(device):
        return {}
    return {"in_use_gb": torch.cuda.memory_allocated(device) / unit,
            "peak_gb": torch.cuda.max_memory_allocated(device) / unit}


def reset_device_peak(device):
    """Start a new peak of a CUDA device's allocated bytes; a no-op for
    any other device."""
    if _is_cuda(device):
        torch.cuda.reset_peak_memory_stats(device)


class MemoryMonitor:
    """Background RSS sampler (memory_tracker.cpp:8-98 equivalent), with
    per-phase device memory of `device` when it is a CUDA device."""

    def __init__(self, interval: float = 0.5, device=None):
        self.interval = interval
        self.device = device
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.idle_gb = 0.0
        self.peak_gb = 0.0
        self._sum = 0.0
        self._count = 0
        self.marks: dict[str, float] = {}
        self.device_marks: dict[str, dict[str, float]] = {}

    def _sample(self):
        rss = host_rss_gb()
        if rss > self.peak_gb:
            self.peak_gb = rss
        self._sum += rss
        self._count += 1

    def _run(self):
        while not self._stop.is_set():
            self._sample()
            self._stop.wait(self.interval)

    def _device_mark(self, name: str):
        """Device memory in use now, and its peak since the last mark."""
        st = device_mem_gb(self.device)
        if st:
            self.device_marks[name] = st
            reset_device_peak(self.device)

    def start(self) -> "MemoryMonitor":
        self._device_mark("idle")
        self.idle_gb = host_rss_gb()
        self.peak_gb = self.idle_gb
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def mark(self, name: str):
        """Record the current RSS under a label (e.g. 'setup')."""
        self._sample()
        self.marks[name] = host_rss_gb()
        self._device_mark(name)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._sample()
        self._device_mark("end")

    @property
    def average_gb(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def report(self) -> dict[str, float]:
        """idle/setup/peak/average + derived overheads of the host, the
        shape the reference prints (DirectSortTest.cpp:172-185); on a
        CUDA device also device_idle_gb (in use at start), for each mark
        device_<mark>_gb (in use there) and device_<mark>_peak_gb (peak
        since the previous mark), device_peak_gb (peak from the last
        mark to stop) and device_end_gb (in use at stop)."""
        setup = self.marks.get("setup", self.idle_gb)
        out = {
            "idle_gb": self.idle_gb,
            "setup_gb": setup,
            "peak_gb": self.peak_gb,
            "average_gb": self.average_gb,
            "crypto_overhead_gb": max(0.0, setup - self.idle_gb),
            "sorting_overhead_gb": max(0.0, self.peak_gb - setup),
        }
        for name, st in self.device_marks.items():
            if name == "idle":
                out["device_idle_gb"] = st["in_use_gb"]
            elif name == "end":
                out["device_peak_gb"] = st["peak_gb"]
                out["device_end_gb"] = st["in_use_gb"]
            else:
                out[f"device_{name}_gb"] = st["in_use_gb"]
                out[f"device_{name}_peak_gb"] = st["peak_gb"]
        return out
