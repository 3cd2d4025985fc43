"""`benchlib.spans` on hand-made profiler events: a kernel counts to the
span open when the runtime call that launched it ran, matched by
``correlation_id()`` (on the H100 the call and its kernels share it; a
graph replay's kernels carry its ``cudaGraphLaunch``'s id, and
``linked_correlation_id()`` names the operation around the call)."""

import pytest

from benchlib import spans


class Ev:
    """A kineto event's methods, as `spans.read` calls them."""

    def __init__(self, name, start, end, device="CPU", corr=0, linked=0,
                 annotation=False):
        self._n, self._s, self._e = name, start, end
        self._d, self._c, self._l, self._a = device, corr, linked, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e9)

    def end_ns(self):
        return int(self._e * 1e9)

    def device_type(self):
        return f"DeviceType.{self._d}"

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def is_user_annotation(self):
        return self._a


def kernel(name, start, end, corr, linked=0):
    return Ev(name, start, end, "CUDA", corr, linked)


def test_a_kernel_counts_to_the_span_that_launched_it():
    events = [
        Ev("bench/request", 0.0, 10.0),
        Ev("net/encode", 1.0, 2.0),
        Ev("aten::mm", 1.2, 1.4, corr=7),
        Ev("cudaLaunchKernel", 1.3, 1.31, corr=501, linked=7),
        Ev("net/decode", 2.0, 5.0),
        Ev("cudaLaunchKernel", 2.5, 2.51, corr=502),
        # launched in net/encode, runs while the host is in net/decode;
        # its linked id is the operation's, whose number a decode call's
        # correlation id happens to share
        kernel("gemm", 3.0, 3.5, corr=501, linked=502),
        kernel("add", 3.5, 3.6, corr=502),
        # the device's copy of a span is not a kernel
        Ev("net/decode", 2.0, 5.0, "CUDA", annotation=True),
    ]
    sp = spans.read(events)
    assert sp.device_s("net/encode") == pytest.approx(0.5)
    assert sp.device_s("net/decode") == pytest.approx(0.1)
    assert sp.device_s("bench/request") == pytest.approx(0.6)
    assert sp.device_s("net/heads") is None
    assert sp.host_s["net/decode"] == pytest.approx(3.0)
    assert sp.requests == 1 and sp.device_events == 2


def test_a_graph_launch_brings_its_kernels_to_its_span():
    events = [Ev("bench/request", 0.0, 4.0), Ev("bench/request", 5.0, 9.0)]
    for k, t in enumerate((1.0, 6.0)):
        events += [Ev("ga/chunk", t, t + 2.0),
                   Ev("cudaGraphLaunch", t + 0.1, t + 0.2, corr=900 + k),
                   Ev("cudaMalloc", t + 0.3, t + 0.5, corr=950 + k)]
        events += [kernel(f"step{j}", t + 0.5 + j * 0.1, t + 0.55 + j * 0.1,
                          corr=900 + k) for j in range(3)]
    events.append(Ev("cudaMalloc", 4.2, 4.3, corr=990))   # outside spans
    sp = spans.read(events)
    assert sp.requests == 2
    assert sp.device_s("ga/chunk") == pytest.approx(6 * 0.05)
    assert sp.call_totals(("cudaGraphLaunch",), ("ga/",)) == (
        2, pytest.approx(0.2))
    assert sp.call_totals(("cudaMalloc",), ("ga/", "recon/")) == (
        2, pytest.approx(0.4))
    assert sp.call_totals(("cudaMalloc",), ("bench/",))[0] == 2


class _Run:
    def __init__(self, events, pairs=30):
        self.records = {"spans": spans.read(events), "recon.pairs": pairs}


def test_readers_divide_by_requests_and_pairs():
    events = [Ev("bench/request", 0.0, 4.0), Ev("bench/request", 4.0, 8.0)]
    for r in range(2):
        for f in range(4):           # 30 pairs: 4 forwards of 8
            t = r * 4.0 + f * 0.5
            events += [Ev("net/encode", t, t + 0.2),
                       Ev("cudaLaunchKernel", t + 0.1, t + 0.11,
                          corr=100 * r + f),
                       kernel("enc", t + 0.3, t + 0.38, corr=100 * r + f)]
    run = _Run(events)
    assert spans.per_request_host_s(run, "net/encode") == pytest.approx(0.8)
    assert spans.per_request_host_s(run, "recon/matching") is None
    # 8 forwards (32 pairs a scene with the padding) of 0.08 s each, over
    # the 2 x 30 pairs the scenes needed
    assert spans.network_ms_per_pair(run, "net/encode") == pytest.approx(
        1e3 * 8 * 0.08 / 60)
    # the number of forwards does not enter, only the pairs needed
    assert spans.network_ms_per_pair(_Run(events, pairs=60),
                                     "net/encode") == pytest.approx(
        1e3 * 8 * 0.08 / 120)
    assert spans.network_ms_per_pair(run, "net/decode") is None
    assert spans.per_request_device_s(run, "net/encode") == pytest.approx(
        0.32)
