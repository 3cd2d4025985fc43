"""Device tracing hooks (port of `starst3r_tpu/utils/profiling.py` on
`torch.profiler`).

Any pipeline phase can be traced into a TensorBoard-format trace directory:

  - explicit: ``with trace_if("ga", trace_dir): ...``
  - ambient: set ``STARST3R_TRACE_DIR``; every `trace_if` block then traces
    into a subdirectory named after its label.

Each block writes one trace of the CPU and, when the card is there, the
CUDA activity (`torch.profiler.tensorboard_trace_handler`) under
``<dir>/<label>/``. Without a directory the block runs untraced and the
profiler is not imported.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

__all__ = ("trace_if", "trace_dir_from_env")

_ENV = "STARST3R_TRACE_DIR"


def trace_dir_from_env() -> Optional[str]:
    return os.environ.get(_ENV) or None


@contextlib.contextmanager
def trace_if(label: str, trace_dir: Optional[str] = None):
    """Trace the enclosed block with torch.profiler when a trace directory
    is given (the argument wins over STARST3R_TRACE_DIR); a no-op
    otherwise."""
    base = trace_dir or trace_dir_from_env()
    if not base:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    path = os.path.join(base, label)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(path)):
        yield
