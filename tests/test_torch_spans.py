"""The port's spans (`utils.profiling.span`) on the CPU:

  - with no profiler recording, `span` returns the shared null context and
    no stage of the request paths enters `record_function`;
  - under `torch.profiler.profile(activities=[CPU])`, `load_images` and
    `reconstruct_scene` (the tiny model at 64 px, GA 4 + 2 with the lora
    depth and the "lm" polish on, so every stage runs) give every
    ``imaging/``, ``recon/``, ``net/`` and ``ga/`` span, the ``net/`` spans
    before matching and the ``ga/`` spans after the condensation
    (``ga/capture`` is the card's: the CPU runs the steps eagerly), and the
    logger's "reconstruct" record keeps its keys;
  - a ``--trace-dir`` trace (`trace_if`) of the network's forwards holds
    the ``net/`` spans, and one of the alignment the ``ga/`` spans;
  - `rasterize` gives ``raster/project``, ``raster/binning``,
    ``raster/pack`` and ``raster/composite``, and no ``raster/binning``
    when ``bins`` is given;
  - `splat.train.stage_events` receives the same stages per step as
    before, and the profiler sees them as ``3dgs/`` spans.
"""

import dataclasses
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile
from torch_threads import one_torch_thread  # noqa: F401

import starst3r_tpu_torch as stt
from starst3r_tpu_torch.alignment import ga as tga
from starst3r_tpu_torch.splat import train as ttrain
from starst3r_tpu_torch.utils import profiling
from starst3r_tpu_torch.utils.metrics import MetricsLogger

from test_torch_rasterize import KW, _scene, _t
from test_torch_train import _fit_problem

tr = importlib.import_module("starst3r_tpu_torch.splat.rasterize")

SIZE = 64
GA = dict(niter1=4, niter2=2, opt_depth=True, lora_depth=True, lora_k=16,
          refine_lm=True, lm_mode="lm")
RECON = ("inference", "matching", "canonical", "condense", "lora_basis",
         "ga", "lm_refine")
# the stages of a training step with pruning and a rebin every step
STEP_STAGES = ["binning", "render", "loss", "backward", "adam", "mcmc"]


def _spans(prof):
    """(name, start, end) of every host range of the trace named as a
    span, in start order."""
    out = [(ev.name(), ev.start_ns(), ev.end_ns())
           for ev in prof.profiler.kineto_results.events()
           if "/" in ev.name() and not str(ev.device_type()).endswith("CUDA")]
    return sorted(out, key=lambda s: s[1])


def _names(spans):
    return [n for n, _, _ in spans]


def _inside(span, spans, parent: str) -> bool:
    _, s, e = span
    return any(n == parent and ps <= s and e <= pe for n, ps, pe in spans)


@pytest.fixture(autouse=True)
def _no_trace_dir(monkeypatch):
    """No `trace_if` profiler of its own: the CLI's ``--trace-dir`` sets
    STARST3R_TRACE_DIR for the rest of its process (tests/test_torch_cli.py
    may have run in this one)."""
    monkeypatch.delenv("STARST3R_TRACE_DIR", raising=False)


@pytest.fixture(scope="module")
def tiny_model():
    return stt.Mast3rModel.init_random(stt.ModelConfig.tiny(), seed=0,
                                       device="cpu")


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    d = tmp_path_factory.mktemp("photos")
    rng = np.random.default_rng(3)
    paths = []
    for i in range(3):
        p = str(d / f"im_{i}.png")
        Image.fromarray(rng.integers(0, 256, (48, 64, 3)).astype(
            np.uint8)).save(p)
        paths.append(p)
    return paths


def _reconstruct(model, photos, tmpdir):
    cfg = stt.default_config()
    cfg = dataclasses.replace(cfg, ga=dataclasses.replace(cfg.ga, **GA))
    logger = MetricsLogger()
    imgs = stt.load_images(photos, size=SIZE)
    rec, _ = stt.reconstruct_scene(model, imgs, device="cpu",
                                   tmpdir=str(tmpdir), config=cfg,
                                   logger=logger)
    rec.get_dense_pts3d()
    return logger


def _render(bins=None):
    args = _t(_scene())
    return tr.rasterize(*args, **KW, bins=bins)


def _train(steps: int):
    pts, cols, gt, w2c, K = _fit_problem(n=128)
    cfg = dataclasses.replace(stt.default_config().splat,
                              mcmc_refine_start=1, mcmc_refine_every=2)
    state = ttrain.init_gaussians(pts, cols, cfg, device="cpu")
    ttrain.run_optim(state, gt, w2c, K, steps, cfg, enable_pruning=True)


class _Event:
    """A stand-in for `torch.cuda.Event` on the CPU."""

    def __init__(self, **kw):
        pass

    def record(self):
        pass


def test_no_profiler_no_record_function(tiny_model, photos, tmp_path,
                                        monkeypatch):
    entered = []
    real = record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return real(self)

    # torch.profiler.record_function is the same class
    monkeypatch.setattr(record_function, "__enter__", counting)
    assert profiling.span("recon/ga") is profiling.NULL_SPAN
    _reconstruct(tiny_model, photos, tmp_path)
    _render()
    _train(2)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("recon/ga"):
            pass
    assert entered == ["recon/ga"]


def test_reconstruction_spans_nest_in_their_stages(tiny_model, photos,
                                                   tmp_path):
    reads = tga._optimize_phase.host_reads
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        logger = _reconstruct(tiny_model, photos, tmp_path)
    reads = tga._optimize_phase.host_reads - reads
    spans = _spans(prof)
    names = _names(spans)
    want = {"imaging/load", "recon/matching", "recon/condense", "net/encode",
            "net/decode", "net/heads", "ga/setup", "ga/chunk", "ga/result"}
    assert want <= set(names), sorted(want - set(names))
    assert "ga/capture" not in names
    # 3 views: 6 pairs in one forward; one span a chunk, as host reads
    for n in ("net/encode", "net/decode", "net/heads"):
        assert names.count(n) == 1, n
    assert names.count("ga/chunk") == reads == 2
    (_, matching, _), = [s for s in spans if s[0] == "recon/matching"]
    (_, _, condensed), = [s for s in spans if s[0] == "recon/condense"]
    for name, start, end in spans:
        if name.startswith("net/"):
            assert end <= matching, name
        if name.startswith("ga/"):
            assert condensed <= start, name
    assert {n.split("/")[0] for n in names} == {"imaging", "recon", "net",
                                                "ga"}
    (rec,) = [r for r in logger.records if r["event"] == "reconstruct"]
    assert set(rec) == {"ts", "event", "n_images", "n_pairs",
                        "loss_coarse", "loss_fine", *RECON}


def test_trace_dir_traces_hold_the_stages(tiny_model, photos, tmp_path,
                                          monkeypatch):
    trace_dir = tmp_path / "traces"
    monkeypatch.setenv("STARST3R_TRACE_DIR", str(trace_dir))
    _reconstruct(tiny_model, photos, tmp_path / "cache")

    def names(label):
        (path,) = (trace_dir / label).glob("*.json")
        return {ev.get("name") for ev in json.loads(
            Path(path).read_text())["traceEvents"]}

    assert {"net/encode", "net/decode", "net/heads"} <= names("inference")
    assert {"ga/setup", "ga/chunk", "ga/result"} <= names("ga")
    assert "recon/matching" not in names("inference") | names("ga")


def test_rasterize_spans():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render()
    assert _names(_spans(prof)) == ["raster/project", "raster/binning",
                                    "raster/pack", "raster/composite"]
    args = _t(_scene())
    bins = tr.bin_gaussians(*args, **{k: v for k, v in KW.items()
                                      if k != "chunk"})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _render(bins=bins)
    assert _names(_spans(prof)) == ["raster/project", "raster/pack",
                                    "raster/composite"]


def test_stage_events_keep_their_stages(monkeypatch):
    steps = 3
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(ttrain, "stage_events", [])
    _train(steps)
    got = [name for name, _, _ in ttrain.stage_events]
    assert got == STEP_STAGES * steps
    monkeypatch.setattr(ttrain, "stage_events", [])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(steps)
    stages = [n[len("3dgs/"):] for n in _names(_spans(prof))
              if n.startswith("3dgs/")]
    assert stages == STEP_STAGES * steps
    assert [name for name, _, _ in ttrain.stage_events] == stages
