"""The idle share's union of device intervals, on synthetic overlapping intervals."""

from perfbench.harness import trace


def test_union_counts_overlaps_once():
    assert trace.union_ns([(0, 10), (5, 15), (20, 30), (25, 26)]) == 25
    assert trace.merge([(20, 30), (0, 10), (5, 15)]) == [(0, 15), (20, 30)]


def test_busy_share_and_gaps():
    events = [("k1", 0, 400_000_000), ("k2", 100_000_000, 500_000_000), ("Memcpy HtoD", 700_000_000, 800_000_000)]
    t = trace.DeviceTrace(events, window_s=1.0, spans=[("selfplay.generate", 0, 600_000_000),
                                                        ("replay.ingest", 600_000_000, 1_000_000_000)])
    assert abs(t.busy_s() - 0.6) < 1e-12
    assert len(t.kernels) == 2
    gaps = t.idle_gaps()
    assert len(gaps) == 1 and abs(gaps[0][1] - 0.2) < 1e-12 and gaps[0][0].startswith("selfplay.generate")
    assert t.top_ops(2) == [["k1", 0.4], ["k2", 0.4]]
    assert t.kernel_seconds("k") == (0.8, 2)
