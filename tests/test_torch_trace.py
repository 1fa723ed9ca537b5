"""The port's tracer (``core/trace.py``) on the CPU at the tiny config: off,
a serving job records nothing and makes no CUDA event or profiler range;
on, the job's spans form one tree under ``dvt.job`` (one ``dvt.denoise`` a
sampling step, one ``dvt.noise`` a host draw), its counters agree with
the benchmark's own count of the same calls, a training step has its four
children, the spans reach ``torch.profiler``'s timeline, CUDA events are
resolved by ``collect`` alone, and the exporter writes Chrome-trace JSON;
then the serve command line's ``--trace_out``."""
import dataclasses
import json
import time

import pytest
import torch

from benchmark import serve as bench_serve
from diff_vits_tpu_torch.core import trace
from diff_vits_tpu_torch.infer import serve as serve_mod
from diff_vits_tpu_torch.models.diff_vits import DiffVits
from diff_vits_tpu_torch.text.symbols import symbols
from diff_vits_tpu_torch.train.trainer import Trainer
from test_torch_cli import files, no_cmudict  # noqa: F401
from test_torch_cli_serve import ROWS, _args, manifest  # noqa: F401
from test_torch_common import tiny_configs
from test_torch_serve import BATCH, REFER, TEXT_BUCKETS, _requests
from test_torch_trainer import _batch

torch.set_num_threads(2)

STEPS = 2
# one mel bucket (no duration pass), and the stochastic predictor with
# three buckets (the duration pass, and its draws)
SETTINGS = {"unet": ("unet", (24,)), "sdp": ("sdp", (6, 12, 24))}


@pytest.fixture(autouse=True)
def _tracer_off():
    trace.disable()
    trace.collect()
    yield
    trace.disable()
    trace.collect()


def _synthesizer(setting="unet"):
    predictor, mel_buckets = SETTINGS[setting]
    _, cfg = tiny_configs()
    cfg = dataclasses.replace(cfg, vits=dataclasses.replace(
        cfg.vits, duration_predictor=predictor))
    torch.manual_seed(0)
    state = DiffVits(cfg, len(symbols), device="cpu").state_dict()
    return serve_mod.BatchSynthesizer(
        cfg, state, batch_size=BATCH, steps=STEPS, text_buckets=TEXT_BUCKETS,
        refer_frames=REFER, mel_buckets=mel_buckets, noise_scale=0.5,
        dtype=torch.float32, device="cpu")


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


class _FakeEvent:
    """Stands in for ``torch.cuda.Event`` on the CPU."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1

    def record(self):
        pass

    def elapsed_time(self, end):
        return 1.5


_synced = []


def test_off_records_nothing_and_makes_no_event_or_range(monkeypatch):
    """Under the profiler (where an enabled span opens a range) and with
    the event constructor in place, the off tracer makes neither."""
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append("event"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: made.append("range"))
    syn = _synthesizer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        syn.synthesize_all(_requests(), seed=3)
    assert made == []
    assert trace.collect() == {"spans": [], "counters": {}}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_a_traced_job_is_one_tree(setting, monkeypatch):
    host_draws = []
    randn = torch.randn

    def counted(*args, **kwargs):
        if kwargs.get("generator") is not None:
            stack = trace._stack()
            host_draws.append(stack[-1].name if stack else None)
        return randn(*args, **kwargs)
    monkeypatch.setattr(torch, "randn", counted)
    syn = _synthesizer(setting)
    trace.enable(events=False)
    results = syn.synthesize_all(_requests(), seed=3)
    got = trace.collect()
    spans = got["spans"]
    by_id = {s["id"]: s for s in spans}

    jobs = [s for s in spans if s["name"] == "dvt.job"]
    assert len(jobs) == 1 and jobs[0]["parent"] is None
    assert jobs[0]["attrs"] == {"requests": len(results)}
    for s in spans:
        assert s["name"].startswith("dvt.")
        assert s["job"] == jobs[0]["id"]
        up = s
        while up["parent"] is not None:
            parent = by_id[up["parent"]]
            assert parent["start_ns"] <= up["start_ns"] <= up["end_ns"] \
                <= parent["end_ns"]
            up = parent
        assert up is jobs[0]
        assert s["device_ms"] is None and s["host_ms"] >= 0

    names = {s["name"] for s in spans}
    front = {"dvt.front.tokenise", "dvt.front.bucket", "dvt.front.pad",
             "dvt.front.gather"}
    assert front | {"dvt.synthesize", "dvt.prior", "dvt.noise",
                    "dvt.denoise"} <= names
    assert ("dvt.front.duration_pass" in names) == (setting == "sdp")
    assert "dvt.vocoder" not in names
    calls = [s for s in spans if s["name"] == "dvt.synthesize"]
    assert len(calls) == got["counters"]["serve.calls"]
    for c in calls:
        assert c["parent"] == jobs[0]["id"]
        assert c["attrs"]["batch"] == BATCH
        assert c["attrs"]["text_bucket"] in TEXT_BUCKETS
        assert c["attrs"]["mel_bucket"] in SETTINGS[setting][1]
        kids = _children(spans, c)
        assert sum(k["name"] == "dvt.denoise" for k in kids) == STEPS
        assert sum(k["name"] == "dvt.prior" for k in kids) == 1
        for k in kids:
            if k["name"] == "dvt.denoise":
                # the kernels' counters do not count the CPU's plain route
                assert k["attrs"] == {"delta": {}}
    # every draw from a generator was a dvt.noise span, and each of them
    # one draw
    noise = [s for s in spans if s["name"] == "dvt.noise"]
    assert host_draws == ["dvt.noise"] * len(noise)
    for s in noise:
        assert str(s["attrs"]["device"]) == "cpu" and \
            s["attrs"]["elements"] > 0
    # the CPU holds what it draws: nothing went to another device
    assert "noise.host_elements" not in got["counters"]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_counters_agree_with_the_benchmarks_count(setting):
    syn = _synthesizer(setting)
    rec = bench_serve.Recorder(serve_mod, syn.model)
    try:
        trace.enable(events=False)
        results = syn.synthesize_all(_requests(), seed=3)
        counters = trace.collect()["counters"]
    finally:
        rec.close()
    assert counters["serve.calls"] == len(rec.calls)
    assert counters["serve.rows"] == BATCH * len(rec.calls)
    assert counters["serve.rows_real"] == len(results) == sum(
        bench_serve._real_rows(c["text"].numpy()) for c in rec.calls)
    assert counters["serve.rows_real"] < counters["serve.rows"]
    assert counters["serve.frames_out"] == sum(len(r[1]) for r in results)
    assert 100.0 * counters["serve.frames_out"] / \
        counters["serve.frames_held"] == pytest.approx(
            bench_serve._frame_fill(rec.calls), rel=1e-12)


def test_a_traced_training_step_has_four_children():
    _, cfg = tiny_configs()
    tr = Trainer(cfg, [], device="cpu")
    trace.enable(events=False)
    tr.train_step(_batch(3))
    spans = trace.collect()["spans"]
    (step,) = [s for s in spans if s["name"] == "dvt.train.step"]
    assert step["parent"] is None and step["attrs"] == {"step": 1}
    kids = sorted(k["name"] for k in _children(spans, step))
    assert kids == ["dvt.train.backward", "dvt.train.forward",
                    "dvt.train.metrics", "dvt.train.optimizer"]
    assert all(s["job"] == step["id"] for s in spans)
    # the denoiser's call in the forward is a span of its own
    (fwd,) = [s for s in spans if s["name"] == "dvt.train.forward"]
    assert any(s["name"] == "dvt.denoise" and s["job"] == step["id"]
               and s["start_ns"] >= fwd["start_ns"] for s in spans)


@pytest.mark.parametrize("on", [False, True])
def test_spans_reach_the_profilers_timeline(on):
    syn = _synthesizer()
    if on:
        trace.enable(events=False)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        syn.synthesize_all(_requests(), seed=3)
    spans = trace.collect()["spans"]
    ranges = sorted(e.name() for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("dvt."))
    assert ranges == sorted(s["name"] for s in spans)
    assert bool(ranges) == on


def test_events_are_resolved_by_collect_alone(monkeypatch):
    """With CUDA events (a stand-in here), no span synchronises; collect
    synchronises once and reads each span's device time."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: _synced.append(1))
    _synced.clear()
    _FakeEvent.made = 0
    syn = _synthesizer()
    trace.enable(events=True)
    syn.synthesize_all(_requests(), seed=3)
    trace.disable()
    assert _synced == []
    spans = trace.collect()["spans"]
    assert _synced == [1]
    assert _FakeEvent.made == 2 * len(spans)
    assert all(s["device_ms"] == 1.5 for s in spans)


def test_export_writes_one_event_a_span(tmp_path):
    syn = _synthesizer()
    trace.enable(events=False)
    syn.synthesize_all(_requests(), seed=3)
    got = trace.collect()
    path = tmp_path / "spans.json"
    trace.export(str(path), got)
    doc = json.loads(path.read_text())
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(events) == len(got["spans"])
    assert doc["otherData"]["counters"] == got["counters"]
    for e, s in zip(events, got["spans"]):
        assert e["name"] == s["name"]
        assert e["dur"] == pytest.approx((s["end_ns"] - s["start_ns"]) / 1e3)
        assert e["args"]["id"] == s["id"] and e["args"]["job"] == s["job"]
    # on the Unix clock, as a torch.profiler export
    job = next(e for e in events if e["name"] == "dvt.job")
    assert abs(job["ts"] / 1e6 - time.time()) < 600


def test_off_span_is_one_shared_context():
    assert trace.span("dvt.x") is trace.span("dvt.y", n=1)
    with trace.span("dvt.x"):
        trace.count("c", 3)
    assert trace.collect() == {"spans": [], "counters": {}}


def test_serve_cli_writes_the_runs_spans(files, manifest, no_cmudict,
                                        tmp_path):
    path = tmp_path / "spans.json"
    serve_mod.main(_args(files, manifest, tmp_path / "out", "--device",
                         "cpu", "--trace_out", str(path)))
    doc = json.loads(path.read_text())
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert names.count("dvt.job") == 1
    assert {"dvt.front.tokenise", "dvt.front.duration_pass",
            "dvt.synthesize"} <= set(names)
    assert doc["otherData"]["counters"]["serve.rows_real"] == len(ROWS)
    assert not trace.enabled()
