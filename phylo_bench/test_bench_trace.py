"""The trace reduction on a hand-made Chrome trace (CPU)."""
import pytest

from trace_reduce import NO_EVENT, WINDOW_SPAN, summarize


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


KERNELS = [_x("kernel", "void walk<4>(float*)", 10, 10),
           _x("kernel", "void walk<4>(float*)", 15, 15),
           _x("gpu_memcpy", "Memcpy HtoD", 50, 10)]


def test_window_span_busy_union_and_named_gaps():
    events = KERNELS + [
        _x("user_annotation", WINDOW_SPAN, 0, 100),
        _x("user_annotation", "bench.engine_call", 2, 96),
        _x("cpu_op", "aten::eigh", 30, 15),
        _x("cpu_op", "aten::copy_", 35, 5),
        _x("kernel", "after the window", 120, 5),
    ]
    s = summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(30e-6)          # [10, 30] and [50, 60]
    assert s.launches == 2
    assert s.idle_share == pytest.approx(0.7)
    assert dict(s.device_ops) == pytest.approx({"walk<4>": 25e-6,
                                                "Memcpy HtoD": 10e-6})
    # gaps [0, 10], [30, 50], [60, 100]: the innermost event through each
    # stretch
    assert dict(s.idle_gaps) == pytest.approx({
        WINDOW_SPAN: 2e-6 + 2e-6,
        "bench.engine_call": 8e-6 + 5e-6 + 38e-6,
        "aten::eigh": 10e-6,
        "aten::copy_": 5e-6,
    })
    assert NO_EVENT not in dict(s.idle_gaps)


def test_device_only_trace_is_bounded_by_its_operations():
    s = summarize(KERNELS)
    assert s.window_s == pytest.approx(50e-6)         # [10, 60]
    assert s.busy_s == pytest.approx(30e-6)
    assert s.idle_gaps == []
