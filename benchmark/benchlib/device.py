"""The card: its published peaks, what a run reports of it, and kernel
timing by CUDA events.

`sleep_cycles_per_ms` and `device_ms` are copied from `chip_smoke.py`
(`sleep_cycles_per_ms`, `device_ms`), with the per-process cache held by
an object here; the peaks are NVIDIA's data sheet for the H100 SXM, dense
rates, at the full 700 W limit (`chip_smoke.py`'s PEAK_BYTES and PEAK_F32,
and bf16)."""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, Optional

PEAK_BYTES = 3.35e12        # HBM3 bytes/s
PEAK_F32 = 67e12            # float32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12          # bfloat16 tensor cores, dense


def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card_limit() -> Optional[str]:
    """``name, power.limit`` as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def device_info(device, count: int) -> Dict:
    """The result line's ``device`` (without the trace's busy time)."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


class KernelTimer:
    """CUDA-event timing of calls queued behind a spin kernel
    (`chip_smoke.py::device_ms`)."""

    def __init__(self):
        self._cycles_per_ms: Optional[float] = None

    def sleep_cycles_per_ms(self) -> float:
        """The card's `torch.cuda._sleep` cycles per millisecond, measured
        once with CUDA events over a 2M-cycle spin."""
        import torch
        if self._cycles_per_ms is None:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_000_000)            # warm
            start.record()
            torch.cuda._sleep(2_000_000)
            end.record()
            end.synchronize()
            self._cycles_per_ms = 2_000_000 / start.elapsed_time(end)
        return self._cycles_per_ms

    def device_ms(self, fn: Callable[[], object], reps: int,
                  warmup: int = 2) -> float:
        """Device time per call of ``fn``: CUDA events around ``reps`` calls
        queued behind a spin kernel that holds the stream until the host
        has queued them all, so the card runs them back to back and the
        host's launch pace does not count. The spin is lengthened until it
        is still running when the host has queued the last call; ``fn``
        must not synchronise."""
        import torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        queue_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(6):
            torch.cuda._sleep(int((2 * queue_ms + 1.0)
                                  * self.sleep_cycles_per_ms()))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            held = not start.query()
            end.synchronize()
            if held:
                return start.elapsed_time(end) / reps
            queue_ms *= 2
        raise RuntimeError(f"device_ms: the host did not queue {reps} calls "
                           "within the spin; the timed function "
                           "synchronises")
