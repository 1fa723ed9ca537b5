"""The harness on the CPU: the manifest and its files, the traffic
generator, the profiler's reduction, what the benchmark may import, and
the run on the card (marked ``gpu``; skips without one).

    python -m pytest benchmark/tests -q
"""
import ast
import importlib.util
import json
import math
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from benchmark import references, trace, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "diff_vits_tpu"}


def test_manifest_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 0 < len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert 0 < len(c["why"]) <= 200 and len(c["reduced"]) <= 16
    assert 1 <= BENCH["run_seconds"] <= 51
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_cell_finds_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        conf = configs[w["config"]]
        assert (ROOT / conf["file"]).is_file()
        assert conf["file"].startswith(tuple(BENCH["paths"]))
        mix = traffic.load(w["traffic"])
        assert mix["kind"] in ("serve", "train")
        limits = json.loads((ROOT / "benchmark" / "limits"
                             / f"{w['name']}.json").read_text())["limits"]
        assert limits and all(v >= 0 for v in limits.values())
    for m in BENCH["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    frozen = ROOT / "benchmark" / "reference"
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        ref = references.resolve(cfg)
        assert all(getattr(ref, n) is not None for n in references.NAMES)
        assert all(callable(getattr(ref.work, n)) for n in references.WORK)
        origin = Path(importlib.util.find_spec(ref.name).origin).resolve()
        assert origin.is_relative_to(frozen), (c["name"], origin)


def _config(name):
    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    return json.loads((ROOT / conf["file"]).read_text())


@pytest.mark.parametrize("name", ["model3", "sdpflow"])
def test_the_cells_keep_the_frozen_reference(name):
    """A configuration that names no reference gets the very objects the
    harness imported before references were named."""
    from benchmark import work
    from benchmark.reference import config, layers, model, vocos
    ref = references.resolve(_config(name))
    assert ref.Config is config.Config and ref.DiffVits is model.DiffVits
    assert ref.synthesize is model.synthesize and ref.Vocos is vocos.Vocos
    assert ref.maximum_path is layers.maximum_path and ref.work is work


def _grid(cell):
    """(config, mix, call shapes) of a cell: every batch, text bucket, mel
    bucket and prompt length its traffic's calls take."""
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    mix = traffic.load(w["traffic"])
    shapes = [(b, t, m, mix["prompt_frames"])
              for b in sorted({1, 3, mix["batch_size"]})
              for t in mix["text_buckets"] for m in mix["mel_buckets"]]
    return _config(w["config"]), mix, shapes


@pytest.mark.parametrize("cell", ["model3-serve-b64", "sdpflow-serve-long"])
def test_the_serving_work_is_counted_as_before(cell):
    """``Recorder.ops`` and ``_row_flops`` through the resolved work count
    give the ``benchmark.work`` lists and totals, over the cell's call
    shapes."""
    from benchmark import serve, work
    cfg_dict, mix, shapes = _grid(cell)
    ref = references.resolve(cfg_dict)
    rcfg = ref.Config.from_dict(cfg_dict)
    steps = mix["steps"]
    rec = types.SimpleNamespace(
        calls=[{"batch": b, "t_bucket": t, "max_len": m, "s_prompt": s}
               for b, t, m, s in shapes],
        prepass=[(b, t, s) for b, t, _, s in shapes],
        vocoder_calls=[(b, m) for b, _, m, _ in shapes])
    want = []
    for b, t, m, s in shapes:
        want += work.synthesize(rcfg, b, t, m, s, 2, steps)
    for b, t, _, s in shapes:
        want += work.predict_lengths(rcfg, b, t, s, 2)
    for b, _, m, _ in shapes:
        want += work.vocoder(b, m, 4)
    assert serve.Recorder.ops(rec, ref.work, rcfg, 0, 0, 0, steps) == want
    for _, t, m, s in shapes:
        assert serve._row_flops(ref.work, rcfg, t, m, s, steps, True) == \
            work.total_flops(work.synthesize(rcfg, 1, t, m, s, 2, steps)
                             + work.vocoder(1, m, 4))


@pytest.mark.parametrize("name", ["model3", "sdpflow"])
def test_the_training_work_is_counted_as_before(name):
    from benchmark import train, work
    cfg_dict = _config(name)
    ref = references.resolve(cfg_dict)
    mix = traffic.load("train-crops")
    run_cfg = train.config(cfg_dict, mix, 2 ** 31 + 1)
    rcfg = ref.Config.from_dict(run_cfg)
    assert train.step_ops(ref, rcfg, mix) == work.train_forward(
        rcfg, mix["batch_size"], mix["text_buffer"], mix["mel_crop"],
        mix["prompt_frames"], 2)


def _module(monkeypatch, name, **attrs):
    mod = types.ModuleType(name)
    vars(mod).update(attrs)
    monkeypatch.setitem(sys.modules, name, mod)


@pytest.mark.parametrize("name,why", [
    ("benchmark.reference.nowhere", "does not import"),
    ("benchmark.work", "is not benchmark.reference"),
    ("benchmark.referencex", "is not benchmark.reference"),
    ("benchmark.reference..model", "is not benchmark.reference"),
    (3, "is not benchmark.reference"),
    ("benchmark.reference.draws", "lacks Config, DiffVits"),
    ("benchmark.reference.test_only_partial", "lacks work.train_forward"),
    ("benchmark.reference.test_only_unhashable", "lacks a hashable work"),
])
def test_a_reference_that_cannot_be_used_is_refused(name, why, monkeypatch):
    from benchmark import work
    from benchmark.reference import model
    whole = dict(Config=object, DiffVits=object, synthesize=model.synthesize,
                 Vocos=object, maximum_path=len)
    _module(monkeypatch, "benchmark.reference.test_only_partial",
            work=type("Partial", (), {n: staticmethod(getattr(work, n))
                                      for n in references.WORK[:3]}),
            **whole)
    _module(monkeypatch, "benchmark.reference.test_only_unhashable",
            work=types.SimpleNamespace(**{n: getattr(work, n)
                                          for n in references.WORK}),
            **whole)
    with pytest.raises(references.BadReference, match=why):
        references.resolve({"reference": name})


@pytest.mark.parametrize("name", ["benchmark.reference.nowhere", "os.path"])
def test_a_run_naming_a_reference_it_cannot_use_ends_before_set_up(
        name, tmp_path):
    """The run ends before it looks for a card (so also here, where a card
    would have ended it), nonzero and with no result line."""
    cfg = _config("model3")
    cfg["reference"] = name
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    cell = BENCH["workloads"][0]
    bench = dict(BENCH, configs=[dict(c, file=str(tmp_path / "c.json"))
                                 for c in BENCH["configs"]])
    code = ("import sys, json; from benchmark import run; "
            f"run.manifest = lambda: json.loads({json.dumps(bench)!r}); "
            f"sys.exit(run.main(['--workload', '{cell['name']}', '--seed', "
            "'1', '--seconds', '1']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert f"reference {name!r}" in p.stderr and "needs" not in p.stderr


def _reports(cell):
    """The end-to-end metrics a cell reports."""
    return {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert m["moves"] in _reports(cell), (m["name"], cell)
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
    for cell in cells:
        assert "setup_s" in _reports(cell) and len(_reports(cell)) >= 2
        assert any(cell in m.get("workloads", [cell])
                   for m in BENCH["per_layer"])


def test_traffic_is_deterministic_and_in_range():
    mix = traffic.load("serve-sentences")
    a = traffic.serve_jobs(mix, 2 ** 31 + 5, 108, 100, 3)
    b = traffic.serve_jobs(mix, 2 ** 31 + 5, 108, 100, 3)
    c = traffic.serve_jobs(mix, 7, 108, 100, 3)
    for ra, rb in zip(a[1], b[1]):
        assert all(np.array_equal(x, y) for x, y in zip(ra[1:], rb[1:]))
    assert not np.array_equal(a[1][0][1], c[1][0][1])
    syl = mix["syllables"]
    lo = 2 * syl["min"] * mix["phones_per_syllable"] + 1
    hi = 2 * syl["max"] * mix["phones_per_syllable"] + 1
    for job in a + c:
        assert len(job) == mix["job_requests"]
        n = sorted(len(r[1]) for r in job)
        assert lo <= n[0] and n[-1] <= hi and n[-1] <= max(
            mix["text_buckets"])
        for r in job:
            assert np.all(r[1][0::2] == 0) and np.all(r[1][1::2] > 0)
            assert r[4].shape == (mix["prompt_frames"], 100)
    # every seed and job says the same lengths, in its own order
    assert sorted(len(r[1]) for r in a[0]) == sorted(len(r[1]) for r in c[2])


def test_training_batches_are_deterministic_and_in_range():
    mix = traffic.load("train-crops")
    small = dict(mix, batch_size=8, pool=2)
    a = traffic.train_batches(small, 11, 108, 100, 2)
    b = traffic.train_batches(small, 11, 108, 100, 2)
    for k in a[0]:
        assert np.array_equal(a[0][k], b[0][k])
    for batch in a:
        assert batch["spec"].shape == (8, mix["mel_crop"], 100)
        assert batch["text"].shape == (8, mix["text_buffer"])
        assert np.all(batch["spec_lengths"] <= mix["mel_crop"])
        assert np.all(batch["text_lengths"] <= batch["spec_lengths"])
        assert np.all(batch["refer1_lengths"] >= 1)
    assert sorted(a[0]["spec_lengths"]) == sorted(a[1]["spec_lengths"])


def test_grid_is_the_distribution_cut_to_its_range():
    g = traffic.grid(256, 18, 0.4, 8, 40)
    assert min(g) >= 8 and max(g) <= 40
    assert abs(np.median(g) - 18) <= 1


def test_profile_reduction_busy_gaps_and_names():
    dev = [(0, 10, "a"), (5, 20, "b"), (30, 40, "a"), (100, 101, "c")]
    host = [(0, 200, "outer"), (50, 90, "inner")]
    s = trace.reduce_events(dev, host, 1e-3)
    assert math.isclose(s["busy_s"], 31e-6)
    assert s["device_ops"][:2] == [["a", 20e-6], ["b", 15e-6]]
    assert s["idle_gaps"][0] == ["inner", 60e-6]
    assert s["idle_gaps"][1] == ["outer", 10e-6]
    assert trace.reduce_events([], host, 1.0)["busy_s"] is None


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (ROOT / "benchmark").rglob("*.py")), ids=lambda p: str(
        p.relative_to(ROOT)))
def test_nothing_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert "diff_vits_tpu_torch" not in tops


def test_the_port_name_is_not_taken_for_the_jax_package():
    assert "diff_vits_tpu_torch".split(".")[0] not in FORBIDDEN


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    cell = BENCH["workloads"][0]["name"]
    code = ("import torch; torch.cuda.is_available = lambda: False; "
            "import sys; from benchmark import run; "
            f"sys.exit(run.main(['--workload', '{cell}', '--seed', '1', "
            "'--seconds', '1']))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(card):
    cell = BENCH["workloads"][0]["name"]
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
         "5", "--seconds", "5"], cwd=ROOT, capture_output=True, text=True,
        timeout=1200)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
