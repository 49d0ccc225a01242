"""The program's spans on the slice's clock (``program_trace.py``) and the
metrics that read them: the offset is the one ``trace.reduce`` applied, the
idle time split by the innermost span sums to the slice's, and every reader
reads None untraced or where the program records no span."""

import threading

import pytest

from benchmark import program_trace, trace
from benchmark.harness import Run, reader

NEW = ("iter_host_ms.finetune", "idle_in_step_ms.finetune",
       "flow_worker_host_ms", "upload_ms.serve")
MAIN = threading.main_thread().ident
WORKER = MAIN + 1
# the host clock less 999 s is the trace's
OFFSET = -999.0
WINDOW = (1.0, 3.0)


def host_spans():
    """The benchmark's spans by the host clock: a frame long before the
    slice, then the slice's frame."""
    return [("h2d", 990.0, 990.25), ("process_frame", 990.25, 991.0),
            ("h2d", 1000.25, 1000.5), ("flow.get", 1000.5, 1000.75),
            ("process_frame", 1000.75, 1002.0),
            ("readback", 1002.0, 1002.125)]


def program(name, parent, id_, thread, t0, t1):
    return program_trace.Span(name, parent, id_, thread, t0, t1)


def recorded():
    """The program's spans by the host clock, in the order they closed."""
    f, i = "online.frame", "online.iter"
    return [
        program("flow.prep", "flow.solve", 7, WORKER, 1000.30, 1000.40),
        program("flow.replay", "flow.solve", 7, WORKER, 1000.40, 1000.50),
        program("online.warp", f, 5, MAIN, 1000.80, 1000.85),
        program("online.prep", f, 5, MAIN, 1000.85, 1000.90),
        program("online.forward", i, 5, MAIN, 1000.90, 1001.00),
        program("online.backward", i, 5, MAIN, 1001.00, 1001.20),
        program("online.update", i, 5, MAIN, 1001.20, 1001.30),
        program(i, f, 5, MAIN, 1000.90, 1001.30),
        program("flow.wait", "flow.solve", 7, WORKER, 1000.50, 1001.40),
        program("flow.solve", None, 7, WORKER, 1000.30, 1001.45),
        program("online.forward", i, 5, MAIN, 1001.30, 1001.40),
        program("online.backward", i, 5, MAIN, 1001.40, 1001.60),
        program("online.update", i, 5, MAIN, 1001.60, 1001.70),
        program(i, f, 5, MAIN, 1001.30, 1001.70),
        program("online.denoise", f, 5, MAIN, 1001.70, 1001.90),
        program(f, None, 5, MAIN, 1000.80, 1001.95),
        # after the slice: left out
        program("online.iter", f, 6, MAIN, 1002.5, 1003.5),
    ]


def fake_run(traced=True):
    spans = trace.Spans()
    spans.done = host_spans()
    lo, hi = WINDOW
    shifted = [(n, a + OFFSET, b + OFFSET) for n, a, b in spans.done
               if a + OFFSET < hi and b + OFFSET > lo]
    # card 0 busy in [1.85, 2.0), [2.1, 2.15), [2.5, 2.6); card 1's
    # operation hides none of card 0's idle time
    ops = [("k", 1.85, 2.0, 0), ("k", 2.1, 2.15, 0), ("k", 2.5, 2.6, 0),
           ("other", 1.0, 3.0, 1)]
    tr = {"ops": ops, "window": WINDOW, "spans": shifted, "items": 1,
          "busy_s": 0.3, "window_s": 2.0, "cards": 1}
    return Run({}, {}, [], spans, {}, tr if traced else None, 1, 50.0)


@pytest.fixture
def program_spans(monkeypatch):
    monkeypatch.setattr(program_trace, "recorded_spans", recorded)


def test_the_offset_is_the_one_the_slice_applied():
    run = fake_run()
    assert program_trace.offset(run) == OFFSET
    # not fooled by an earlier span of the same name and length
    assert run.spans.done[0][2] - run.spans.done[0][1] == \
        run.spans.done[2][2] - run.spans.done[2][1]
    run.trace["spans"] = []
    assert program_trace.offset(run) is None


def test_program_spans_land_in_the_window(program_spans):
    got = program_trace.spans(fake_run())
    assert len(got) == len(recorded()) - 1
    frame, = [s for s in got if s.name == "online.frame"]
    assert frame.t0 == pytest.approx(1.80) and frame.t1 == pytest.approx(2.95)
    assert all(WINDOW[0] <= s.t0 and s.t1 <= WINDOW[1] for s in got)


def test_idle_by_the_innermost_span_sums_to_the_slice_idle(program_spans):
    run = fake_run()
    lo, hi = WINDOW
    idle = sum(e - s for s, e in trace.idle_gaps(
        [(a, b) for _, a, b, d in run.trace["ops"] if d == 0], lo, hi))
    parts = program_trace.idle_by_span(run)
    assert sum(parts.values()) == pytest.approx(idle)
    assert parts["online.warp"] == pytest.approx(0.05)
    assert parts["online.forward"] == pytest.approx(0.1)
    assert parts["online.backward"] == pytest.approx(0.1 + 0.05 + 0.1)
    assert parts["online.update"] == pytest.approx(0.1 + 0.1)
    assert parts["online.denoise"] == pytest.approx(0.2)
    assert parts["online.frame"] == pytest.approx(0.05)  # its own tail
    assert parts["none"] == pytest.approx(0.8 + 0.05)
    assert "online.iter" not in parts  # its children cover it
    assert not [n for n in parts if n.startswith("flow.")]
    # the worker's own split
    worker = program_trace.idle_by_span(run, thread=WORKER)
    assert sum(worker.values()) == pytest.approx(idle)
    assert worker["flow.wait"] == pytest.approx(0.9 - 0.15 - 0.05)


def test_the_readers_read_the_fake_slice(program_spans):
    run = fake_run()
    got = {m: reader(m).read(run) for m in NEW}
    assert got["iter_host_ms.finetune"] == pytest.approx(400.0)
    # idle inside the two updates: 0.1 + 0.25 + 0.2 s, one traced frame
    assert got["idle_in_step_ms.finetune"] == pytest.approx(550.0)
    assert got["flow_worker_host_ms"] == pytest.approx(1150.0 - 900.0)
    assert got["upload_ms.serve"] is None  # no serving span


@pytest.mark.parametrize("metric", NEW)
def test_each_reader_reads_none_untraced(metric, program_spans):
    assert reader(metric).read(fake_run(traced=False)) is None


@pytest.mark.parametrize("metric", NEW)
def test_each_reader_reads_none_without_a_recorder(metric, monkeypatch):
    # a program that records no span (a parent without the recorder)
    monkeypatch.setattr(program_trace, "recorded_spans", lambda: None)
    assert reader(metric).read(fake_run()) is None


def test_the_recorder_of_this_process_is_read():
    from frame2frame_tpu_torch.utils import profiling

    profiling.clear()
    assert program_trace.recorded_spans() == []
