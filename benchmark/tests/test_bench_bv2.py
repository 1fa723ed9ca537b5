"""bv2 (``benchmark/configs/bv2.json``, its own reference
``benchmark.reference.bv2``) through a whole serving run at tiny widths on
the CPU, held to ``bv2-serve-long``'s limits: the program passes them, the
control (the reference in float8 products in the program's place) fails
them, and so does an answer altered where it is made; at the seeds
``test_bench_control.py`` gives every serving cell. At the cell's own size
the same readings come from ``python3 -m benchmark.control --workload
bv2-serve-long`` on the card."""
from benchmark import check
from benchmark.tests.test_bench_control import limits, run_serve

CELL, CONFIG, MIX = "bv2-serve-long", "bv2", "serve-paragraphs"


def test_program_passes_and_control_fails(monkeypatch):
    out = run_serve(CONFIG, MIX, 2 ** 31 + 3, monkeypatch, control=True)
    assert check.verdict(out["numbers"], limits(CELL)), out["numbers"]
    assert not check.verdict(out["ctx"]["control"], limits(CELL)), \
        out["ctx"]["control"]


def test_an_answer_altered_where_it_is_made_fails(monkeypatch):
    from diff_vits_tpu_torch.infer import serve as serve_mod
    inner = serve_mod.synthesize

    def altered(*args, **kwargs):
        mel, lengths = inner(*args, **kwargs)
        return mel + 0.3 * mel.std(), lengths
    monkeypatch.setattr(serve_mod, "synthesize", altered)
    out = run_serve(CONFIG, MIX, 2 ** 31 + 4, monkeypatch)
    assert not check.verdict(out["numbers"], limits(CELL))
