"""``trace_idle.idle_by_span`` on synthetic event lists: each gap between
device activities goes to the innermost ``dvt.`` range open at its
middle, an ATen operation open there or not, and to ``(no span)`` outside
every range; together they are every gap ``reduce_events`` finds."""
import pytest

from benchmark import trace, trace_idle

# host ranges (us): a job over two calls; the second call's noise draw
# holds an ATen op
HOST = [(0, 1000, "dvt.job"), (100, 400, "dvt.synthesize"),
        (120, 180, "dvt.noise"), (500, 900, "dvt.synthesize"),
        (520, 700, "dvt.noise"), (530, 690, "aten::normal_"),
        (1200, 1300, "aten::copy_")]


@pytest.mark.parametrize("dev,want", [
    # a gap inside the first call's draw, the innermost of three ranges
    ([(0, 130, "k"), (170, 300, "k")], {"dvt.noise": 40e-6}),
    # a gap inside a call, outside its draw: the call
    ([(0, 200, "k"), (260, 300, "k")], {"dvt.synthesize": 60e-6}),
    # a gap between the calls: the job
    ([(0, 420, "k"), (480, 600, "k")], {"dvt.job": 60e-6}),
    # a gap under an ATen op inside a span: the span, not the op
    ([(0, 540, "k"), (680, 900, "k")], {"dvt.noise": 140e-6}),
    # a gap outside every span, under an ATen op of its own
    ([(0, 1100, "k"), (1400, 1500, "k")], {trace_idle.OUTSIDE: 300e-6}),
    # overlapping activities leave no gap; nested ones neither
    ([(0, 300, "k"), (100, 200, "k"), (250, 400, "k")], {}),
])
def test_each_gap_goes_to_the_innermost_span(dev, want):
    got = trace_idle.idle_by_span(dev, HOST)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k])


def test_the_gaps_are_those_of_reduce_events():
    dev = [(0, 130, "k"), (170, 300, "k"), (320, 420, "k"), (480, 540, "k"),
           (680, 1100, "k"), (1400, 1500, "k")]
    got = trace_idle.idle_by_span(dev, HOST)
    summary = trace.reduce_events(dev, HOST, 2e-3)
    assert sum(got.values()) == pytest.approx(
        summary["window_s"] - summary["busy_s"] - 500e-6)
    assert sum(got.values()) == pytest.approx(
        sum(s for _, s in summary["idle_gaps"]))
    assert got == pytest.approx({"dvt.noise": 180e-6,
                                 "dvt.synthesize": 20e-6,
                                 "dvt.job": 60e-6,
                                 trace_idle.OUTSIDE: 300e-6})
    assert trace_idle.idle_by_span([], HOST) == {}
