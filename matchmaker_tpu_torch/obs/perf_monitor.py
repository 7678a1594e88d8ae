"""Named block timers + throughput accounting: the port's copy of
``matchmaker_tpu/obs/perf_monitor.py``.

Behavioral contract with the reference (`matchmaker/utils/performance_monitor.py:22-155`):
a process-wide singleton with ``start_block``/``stop_block(category, instances)``,
median/95th-percentile latency, items/sec, and a JSON export
(``efficiency-metrics.json``). Additions: device-hours (``chip_hours``),
optional ``torch.profiler`` trace capture around a block, and MFU estimation
when a FLOP count is supplied.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np


class PerformanceMonitor:
    _instance: Optional["PerformanceMonitor"] = None

    @staticmethod
    def get() -> "PerformanceMonitor":
        if PerformanceMonitor._instance is None:
            PerformanceMonitor._instance = PerformanceMonitor()
        return PerformanceMonitor._instance

    def __init__(self) -> None:
        self.timings: Dict[str, List[float]] = defaultdict(list)
        self.instances: Dict[str, List[int]] = defaultdict(list)
        self.flops: Dict[str, float] = defaultdict(float)
        self._open: Dict[str, float] = {}
        self.n_devices: int = 1

    # -- timing API ---------------------------------------------------------
    def start_block(self, category: str) -> None:
        self._open[category] = time.perf_counter()

    def capture_trace(self, log_dir: str):
        """Context manager: a torch.profiler trace of a block (CPU and, on a
        card, CUDA activity), written as a Chrome trace into ``log_dir`` —
        the analog of the reference's commented pprofile hooks
        (dense_retrieval.py:217-218)."""
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        import torch

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))

    def stop_block(self, category: str, instances: int = 1, flops: float = 0.0) -> None:
        start = self._open.pop(category, None)
        if start is None:
            return
        self.timings[category].append(time.perf_counter() - start)
        self.instances[category].append(instances)
        self.flops[category] += flops

    def log_value(self, category: str, value: float) -> None:
        self.timings[category].append(value)
        self.instances[category].append(1)

    # -- reporting ----------------------------------------------------------
    def summary(self, peak_flops_per_device: float = 0.0) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for cat, times in self.timings.items():
            t = np.array(times)
            n = np.array(self.instances[cat])
            total = float(t.sum())
            stats = {
                "total_seconds": total,
                "median_seconds": float(np.median(t)),
                "p95_seconds": float(np.percentile(t, 95)),
                "calls": int(t.size),
                "instances": int(n.sum()),
                "items_per_second": float(n.sum() / total) if total > 0 else 0.0,
                "chip_hours": total * self.n_devices / 3600.0,
            }
            if self.flops[cat] and total > 0:
                stats["tflops_per_second"] = self.flops[cat] / total / 1e12
                if peak_flops_per_device:
                    stats["mfu"] = self.flops[cat] / total / (peak_flops_per_device * self.n_devices)
            out[cat] = stats
        return out

    def print_summary(self, peak_flops_per_device: float = 0.0) -> None:
        for cat, stats in self.summary(peak_flops_per_device).items():
            line = (
                f"[perf] {cat:<24} total={stats['total_seconds']:.3f}s "
                f"median={stats['median_seconds'] * 1000:.1f}ms p95={stats['p95_seconds'] * 1000:.1f}ms "
                f"items/s={stats['items_per_second']:.1f}"
            )
            if "mfu" in stats:
                line += f" mfu={stats['mfu'] * 100:.1f}%"
            print(line)

    def save_summary(self, path: str, peak_flops_per_device: float = 0.0) -> None:
        """Append this run's summary to efficiency-metrics.json (reference :105-155)."""
        existing: List[dict] = []
        if os.path.exists(path):
            with open(path, "r", encoding="utf-8") as f:
                try:
                    existing = json.load(f)
                except json.JSONDecodeError:
                    existing = []
        existing.append({"timestamp": time.time(), "blocks": self.summary(peak_flops_per_device)})
        with open(path, "w", encoding="utf-8") as f:
            json.dump(existing, f, indent=1)
