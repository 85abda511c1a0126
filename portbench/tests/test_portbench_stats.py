"""The arithmetic of the end-to-end metrics and of the trace's idle share,
on synthetic timings and a synthetic trace."""

import pytest

from portbench import stats, trace


def test_window_arithmetic():
    assert stats.per_request_ms(35.2, 110) == pytest.approx(320.0)
    assert stats.per_request_ms(1.0, 0) is None


def test_p90_by_nearest_rank():
    assert stats.p90(range(1, 101)) == 90
    assert stats.p90(range(1, 102)) == 91
    assert stats.p90([5.0]) == 5.0
    assert stats.p90([3, 1, 2]) == 3
    assert stats.p90([1] * 9 + [100]) == 1
    assert stats.p90([1] * 8 + [100, 100]) == 100
    assert stats.p90([]) is None


def test_readers_on_synthetic_timings():
    from portbench import spec as specs
    obs = dict(setup_s=31.5, window_s=35.5, completed=100,
               request_s=[0.3] * 89 + [0.5] * 11,
               mix={"op": "factorize"}, records=[])
    read = {n: specs.load_module("metrics", n).read for n in
            ("factorize_ms", "factorize_p90_ms", "solve_ms", "setup_s")}
    assert read["factorize_ms"](obs) == pytest.approx(355.0)
    assert read["factorize_p90_ms"](obs) == pytest.approx(500.0)
    assert read["solve_ms"](obs) is None
    assert read["setup_s"](obs) == 31.5


def test_idle_share_on_a_synthetic_trace():
    # two requests over [0, 100] us; device ops overlap in [10, 30], then
    # [40, 50] and [95, 120], which the window clips at 100
    spans = [("request", 0, 60), ("request", 60, 100),
             ("entry_values", 0, 10), ("replay", 30, 40),
             ("factorize", 0, 60), ("factorize", 60, 100)]
    ops = [("k1", 10, 20), ("k2", 15, 30), ("k1", 40, 50),
           ("Memcpy HtoD", 95, 120), ("k1", 200, 300)]
    s = trace.summarize(ops, spans)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)
    assert s["kernel_s"]["k1"] == pytest.approx(20e-6)
    assert s["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    gaps = s["idle_gaps"]
    # [50, 95] inside the factorize spans, [0, 10] in entry_values,
    # [30, 40] in replay
    assert gaps[0] == ["factorize", pytest.approx(45e-6)]
    assert sorted(g[0] for g in gaps) == ["entry_values", "factorize",
                                          "replay"]
    from portbench import spec as specs
    obs = {"trace": dict(s, requests=2)}
    idle = specs.load_module("metrics", "device_idle_pct.refactor").read
    assert idle(obs) == pytest.approx(65.0)
    assert idle({}) is None


def test_union():
    assert trace.union([(5, 6), (1, 3), (2, 4)]) == [[1, 4], [5, 6]]
