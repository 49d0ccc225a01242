"""The port's spans and counters (``utils/profiling.py``) on the CPU.

- with no profiler running, ``annotate`` returns one shared context and
  nothing is recorded;
- under a CPU profiler, ``process_frame`` on a small DnCNN, on both routes
  of ``make_online_step``, records one ``online.frame`` with ``iters``
  ``online.iter`` children, each with forward, backward and update
  children, all with the frame's id;
- ``AsyncFlowSolver(device="cpu")`` records ``flow.solve`` and its
  ``flow.prep`` on the worker's thread, ``flow.result`` on the caller's;
- ``load_model(cfg).apply`` records ``serve.apply`` with its children and
  the route's counter;
- ``trace_if`` clears the recorder on entry and writes ``spans.json``
  beside ``trace.json``;
- threads that record at once lose no span and no count.
"""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from frame2frame_tpu_torch import load_model  # noqa: E402
from frame2frame_tpu_torch.flow.tvl1 import DENOISING_PARAMS  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import init_dncnn  # noqa: E402
from frame2frame_tpu_torch.train import online  # noqa: E402
from frame2frame_tpu_torch.utils import profiling  # noqa: E402

H = W = 32
ITERS = 3
STEP_CHILDREN = {"online.forward", "online.backward", "online.update"}


def profiled(fn):
    """``fn()`` under a CPU profiler, with the recorder emptied first; the
    spans and counters it recorded."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    rec = profiling.recorded()
    profiling.clear()
    return rec


def named(spans, name):
    return [s for s in spans if s.name == name]


def test_without_a_profiler_nothing_is_recorded():
    profiling.clear()
    ctx = profiling.annotate("online.frame", 1)
    assert ctx is profiling.annotate("flow.solve")
    with ctx:
        with profiling.annotate("online.iter"):
            profiling.count("online.route.flat")
    assert profiling.recorded() == {"spans": [], "counters": {}}


def test_spans_nest_and_inherit_the_id():
    def body():
        with profiling.annotate("outer", 7):
            with profiling.annotate("inner"):
                profiling.count("c", 2)
            profiling.count("c")
        with profiling.annotate("alone"):
            pass

    rec = profiled(body)
    inner, outer, alone = rec["spans"]  # in the order they closed
    assert (inner.name, inner.parent, inner.id) == ("inner", "outer", 7)
    assert (outer.name, outer.parent, outer.id) == ("outer", None, 7)
    assert (alone.parent, alone.id) == (None, None)
    assert outer.t0 <= inner.t0 <= inner.t1 <= outer.t1 <= alone.t0
    assert {s.thread for s in rec["spans"]} == {threading.get_ident()}
    assert rec["counters"] == {"c": 3}


def test_threads_lose_no_span_and_no_count():
    """More threads than cores, switching often, each nesting spans and
    adding to one counter: every span and every count is kept, and each
    thread's spans name their own parents."""
    import os
    import sys

    n_threads, n_spans = 2 * (os.cpu_count() or 4), 200

    def work(k):
        for j in range(n_spans):
            with profiling.annotate("outer", (k, j)):
                with profiling.annotate("inner"):
                    profiling.count("hits")

    def body():
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rec = profiled(body)
    finally:
        sys.setswitchinterval(interval)
    assert rec["counters"] == {"hits": n_threads * n_spans}
    spans = rec["spans"]
    assert len(spans) == 2 * n_threads * n_spans
    outer = {s.id: s for s in named(spans, "outer")}
    assert len(outer) == n_threads * n_spans
    for s in named(spans, "inner"):
        up = outer[s.id]
        assert s.parent == "outer" and s.thread == up.thread
        assert up.t0 <= s.t0 <= s.t1 <= up.t1


def frames(seed=3):
    rng = np.random.default_rng(seed)
    cur, prev = rng.random((2, H, W, 1)).astype(np.float32)
    flow = (rng.standard_normal((H, W, 2)) * 0.5).astype(np.float32)
    return cur, prev, flow


@pytest.mark.parametrize("flat_step", [None, False])
def test_process_frame_records_each_update(flat_step):
    model, variables = init_dncnn(0, channels=1, num_layers=4,
                                  conv_impl="fused")
    eng = online.OnlineDenoiser(model, variables, iters=ITERS, device="cpu",
                                flat_step=flat_step)
    cur, prev, flow = frames()
    eng.process_frame(cur, prev, flow)  # frame 1, not profiled
    rec = profiled(lambda: eng.process_frame(cur, prev, flow))
    spans = rec["spans"]
    frame, = named(spans, "online.frame")
    assert frame.id == 2 and frame.parent is None
    iters = named(spans, "online.iter")
    assert len(iters) == ITERS
    assert all(s.parent == "online.frame" and s.id == 2 for s in iters)
    for it in iters:
        inside = [s for s in spans if it.t0 <= s.t0 and s.t1 <= it.t1
                  and s is not it]
        assert sorted(s.name for s in inside) == sorted(STEP_CHILDREN)
        assert all(s.parent == "online.iter" and s.id == 2 for s in inside)
    route = "online.route.flat" if flat_step is None else "online.route.iter"
    assert rec["counters"] == {route: 1}
    for name in ("online.warp", "online.denoise"):
        s, = named(spans, name)
        assert s.parent == "online.frame" and s.id == 2
    assert len(named(spans, "online.prep")) == (flat_step is None)
    for name in ("online.forward", "online.backward", "online.update"):
        assert len(named(spans, name)) == ITERS


def test_flow_solver_records_on_its_worker_thread():
    rng = np.random.default_rng(4)
    vid = rng.random((3, 24, 40, 1)).astype(np.float32)
    solver = online.AsyncFlowSolver(40, 24, dict(DENOISING_PARAMS, fscale=0),
                                    lookahead=2, device="cpu")

    def body():
        for i in (1, 2):
            solver.prefetch(i, vid[i], vid[i - 1])
        for i in (1, 2):
            solver.get(i)

    rec = profiled(body)
    solver.close()
    spans = rec["spans"]
    solves = named(spans, "flow.solve")
    assert sorted(s.id for s in solves) == [1, 2]
    main = threading.get_ident()
    assert all(s.thread != main and s.parent is None for s in solves)
    for s in solves:
        prep, = [p for p in named(spans, "flow.prep") if p.id == s.id]
        assert prep.parent == "flow.solve" and prep.thread == s.thread
        assert s.t0 <= prep.t0 <= prep.t1 <= s.t1
    results = named(spans, "flow.result")
    assert sorted(s.id for s in results) == [1, 2]
    assert all(s.thread == main for s in results)
    assert len(solver.solve_times) == 2


def test_apply_records_upload_route_and_forward():
    loaded = load_model({"net_name": "dncnn", "channels": 1,
                         "num_of_layers": 4, "conv_impl": "fused"},
                        device="cpu")
    x = np.random.default_rng(5).random((2, 16, 16, 1)).astype(np.float32)
    loaded.apply(x)  # call 1, not profiled
    rec = profiled(lambda: loaded.apply(x))
    spans = rec["spans"]
    call, = named(spans, "serve.apply")
    assert call.id == 2
    kids = [s for s in spans if s is not call]
    assert [s.name for s in kids] == ["serve.upload", "serve.route",
                                      "serve.forward"]
    assert all(s.parent == "serve.apply" and s.id == 2 for s in kids)
    # on the CPU the eval call takes the module's forward
    assert rec["counters"] == {"serve.route.module": 1}


def test_trace_if_writes_the_spans_beside_the_trace(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.annotate("left.over"):
            pass
    assert profiling.recorded()["spans"]
    with profiling.trace_if(str(tmp_path)):
        with profiling.annotate("online.frame", 1):
            profiling.count("online.route.flat")
    assert (tmp_path / "trace.json").exists()
    out = json.loads((tmp_path / "spans.json").read_text())
    # the recorder was emptied on entry: the earlier span is not written
    assert [s["name"] for s in out["spans"]] == ["online.frame"]
    s = out["spans"][0]
    assert set(s) == {"name", "parent", "id", "thread", "t0", "t1"}
    assert s["id"] == 1 and s["thread"] == out["main_thread"]
    assert out["counters"] == {"online.route.flat": 1}
    assert out["clock"] == "time.perf_counter"
    profiling.clear()
