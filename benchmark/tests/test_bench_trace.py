"""The idle share is a union of device intervals, the breakdown names gaps
by the host span open at the time, and rates and tails are taken over all
the window's samples."""

import numpy as np
import pytest

from benchmark import reduce, trace
from benchmark.harness import Run


def test_two_overlapping_kernels_on_two_streams_count_once():
    # stream A runs [0, 4), stream B [2, 6): busy 6 of 10, not 8
    assert trace.union_seconds([(0.0, 4.0), (2.0, 6.0)], 0.0, 10.0) == 6.0
    assert trace.union_seconds([(2.0, 6.0), (0.0, 4.0), (8.0, 9.0)],
                               0.0, 10.0) == 7.0
    # clipped to the window
    assert trace.union_seconds([(-1.0, 1.0), (9.0, 12.0)], 0.0, 10.0) == 2.0


def test_idle_gaps_are_the_complement_of_the_union():
    gaps = trace.idle_gaps([(1.0, 3.0), (2.0, 4.0), (6.0, 7.0)], 0.0, 10.0)
    assert gaps == [(0.0, 1.0), (4.0, 6.0), (7.0, 10.0)]
    assert trace.idle_gaps([(0.0, 10.0)], 0.0, 10.0) == []


def fake_trace():
    ops = [("kernel_a", 0.0, 4.0, 0), ("kernel_b", 2.0, 6.0, 0),
           ("Memcpy DtoH (Device -> Pageable)", 8.0, 9.0, 0)]
    spans = [("process_frame", 0.0, 7.5), ("readback", 7.5, 9.5),
             ("flow.get", 9.5, 10.0)]
    busy = trace.union_seconds([(s, e) for _, s, e, _ in ops], 0.0, 10.0)
    return {"ops": ops, "window": (0.0, 10.0), "spans": spans, "items": 2,
            "busy_s": busy, "window_s": 10.0, "cards": 1}


def test_breakdown_names_each_gap_by_the_open_span():
    b = trace.breakdown(fake_trace())
    assert dict(b["idle_gaps"]) == {"process_frame": 1.5, "readback": 1.0,
                                    "flow.get": 0.5}
    assert b["device_ops"][0] == ["kernel_a", 4.0]
    assert len(b["device_ops"]) <= trace.BREAKDOWN_ENTRIES


def run_of(records, window_s, tr=None, config=None, params=None):
    return Run(config or {}, params or {}, records, trace.Spans(), {}, tr, 1,
               window_s)


def test_idle_share_and_kernel_counts_from_the_slice():
    run = run_of([], 1.0, fake_trace())
    assert reduce.idle_percent(run) == pytest.approx(30.0)
    # the copy is an operation of the device, not a kernel
    assert len(reduce.slice_ops(run)) == 2
    assert reduce.idle_percent(run_of([], 1.0)) is None


def records(latencies, items=1):
    t, out = 0.0, []
    for lat in latencies:
        out.append({"t0": t, "t1": t + lat, "items": items, "traced": False})
        t += lat
    return out


def test_rate_is_all_the_work_over_all_the_window():
    lats = [0.1] * 90 + [1.0] * 10  # a slow tail
    run = run_of(records(lats, items=8), sum(lats))
    assert reduce.rate(run) == pytest.approx(800 / 19.0)
    # not the median of chunks' rates, which would hide the tail
    assert reduce.rate(run) < 8 / 0.1


def test_tail_is_over_every_record():
    lats = [0.1] * 94 + [1.0] * 6
    run = run_of(records(lats), sum(lats))
    assert reduce.tail_ms(run, 95) == pytest.approx(
        np.percentile(np.array(lats) * 1e3, 95))
    assert reduce.tail_ms(run, 95) > 500


def test_roofline_share_sums_launches_against_their_time():
    tr = fake_trace()
    tr["ops"] = [("bwd_layer_k", 0.0, 0.002, 0), ("bwd_layer_k", 0.003,
                                                  0.005, 0)]
    run = run_of([], 1.0, tr)
    # two launches of a 1 ms bound in 4 ms
    assert reduce.roofline_percent(run, "bwd_layer", 1.0) == \
        pytest.approx(50.0)
    assert reduce.roofline_percent(run, "fwd_layer", 1.0) is None


def test_mfu_leaves_the_traced_records_out():
    recs = records([1.0, 1.0, 3.0])
    recs[2]["traced"] = True
    run = run_of(recs, 5.0, config={"peak_flop_per_s": 100.0})
    assert reduce.mfu_percent(run, 50.0) == pytest.approx(50.0)


class FakeProf:
    """A profiler record with the device events given as (name, start_us,
    end_us)."""

    def __init__(self, events):
        import torch
        from types import SimpleNamespace as NS

        cuda = torch.autograd.DeviceType.CUDA
        self._events = [NS(name=n, device_type=cuda, device_index=0,
                           time_range=NS(start=a, end=b))
                        for n, a, b in events]

    def events(self):
        return self._events


KERNELS = [("k", 1_000_000 + 100 * i, 1_000_000 + 100 * i + 60)
           for i in range(100)]
SPIN = "at::cuda::spin_kernel(long)"
# the host clock just before each marker's launch: two probes after the
# profiler opens, the slice's opening marker, its closing marker; on the
# trace's clock the host's 5.0 s is 0.999 s
HOST = [4.2, 4.8, 5.0, 5.012]
MARKS = [(SPIN, int((h - 4.001) * 1e6), int((h - 4.001) * 1e6) + 10)
         for h in HOST]
SPANS = [("process_frame", 5.0005, 5.011)]


@pytest.mark.parametrize("kept", [[0, 1, 2, 3], [1, 2, 3]])
def test_the_markers_put_the_host_spans_on_the_device_clock(kept):
    marks = [MARKS[i] for i in kept]
    tr = trace.reduce(FakeProf(marks + KERNELS), HOST, SPANS, 3, 1)
    assert tr["markers"] == f"{kept} of 4"
    assert abs(tr["lag_s"]) < 1e-6
    lo, hi = tr["window"]
    assert lo == pytest.approx(0.99901, abs=2e-6)
    assert hi == pytest.approx(1.011, abs=2e-6)
    # the span lands where it ran on the device's clock
    (_, a, b), = tr["spans"]
    assert a == pytest.approx(0.9995, abs=2e-6)
    assert tr["busy_s"] == pytest.approx(100 * 60e-6)


@pytest.mark.parametrize("kept", [[0, 1, 3], [0, 1, 2], [2, 3], []])
def test_a_slice_without_its_opening_or_closing_marker_raises(kept):
    marks = [MARKS[i] for i in kept]
    with pytest.raises(RuntimeError, match="marker is not found"):
        trace.reduce(FakeProf(marks + KERNELS), HOST, SPANS, 3, 1)


def test_a_closing_marker_too_late_is_not_kept():
    # 0.6 s after its clock read: not the slice's
    moved = (SPIN, MARKS[3][1] + 600_000, MARKS[3][2] + 600_000)
    with pytest.raises(RuntimeError, match="closing marker"):
        trace.reduce(FakeProf(MARKS[:3] + [moved] + KERNELS), HOST, SPANS,
                     3, 1)
    # a probe off the opening marker's offset is not kept either
    moved = (SPIN, MARKS[0][1] + 30_000, MARKS[0][2] + 30_000)
    found = trace.match_markers(
        sorted((a / 1e6, b / 1e6) for _, a, b in [moved] + MARKS[1:]), HOST)
    assert sorted(found) == [1, 2, 3]


def test_a_slice_with_no_marker_before_its_opening_one_raises():
    # without a probe that sides with it, the opening marker could be a
    # probe taken for it: the uneven spacing makes a shifted set disagree
    with pytest.raises(RuntimeError, match="opening marker"):
        trace.reduce(FakeProf(MARKS[2:] + KERNELS), HOST, SPANS, 3, 1)


def test_a_closing_marker_that_waited_to_launch_is_kept():
    # it started 73 ms after its clock read; the slice ends at the read
    late = (SPIN, MARKS[3][1] + 73_000, MARKS[3][2] + 73_000)
    tr = trace.reduce(FakeProf(MARKS[:3] + [late] + KERNELS), HOST, SPANS,
                      3, 1)
    assert tr["markers"] == "[0, 1, 2, 3] of 4"
    assert tr["lag_s"] == pytest.approx(0.073, abs=2e-6)
    assert tr["window"][1] == pytest.approx(1.011, abs=2e-6)
    assert tr["busy_s"] == pytest.approx(100 * 60e-6)
