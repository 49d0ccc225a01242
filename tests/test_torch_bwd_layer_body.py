"""Which body of ``csrc/fused_stack_bwd.cu`` the wrapper
``ops/fused_stack.bwd_layer`` counts, and when.

- A device tensor (here on the "meta" device, with the library, the
  current-device check and the stream faked) takes the launch path on both
  chains: one call of ``f2f_bwd_layer_window`` with the dtype's ``is_f32``
  flag, one ``bwd_layer.launches``, and one ``kernel.bwd_layer.wgmma`` in the
  program's recorder while a profiler records (the bf16 and the f32 chain run
  the one wgmma body); none without a profiler.
- A CPU tensor takes ``bwd_layer_plain``: the same bits, no launch counted
  in ``bwd_layer.launches``, and nothing on the card's counters of the
  recorder, even while a profiler session records.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frame2frame_tpu_torch.ops import fused_stack as fs  # noqa: E402
from frame2frame_tpu_torch.utils import profiling  # noqa: E402

C = 64
CPU_PROFILER = [torch.profiler.ProfilerActivity.CPU]


def inputs(shape, dt, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)

    def t(scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(
            shape + (C,))).astype(np.float32)).to(dt).contiguous()

    w = torch.from_numpy((rng.standard_normal((3, 3, C, C))
                          * np.sqrt(2.0 / (9 * C))).astype(np.float32))
    vecs = np.stack([1.0 + 0.2 * rng.standard_normal(C),
                     0.1 * rng.standard_normal(C),
                     1e-3 * rng.standard_normal(C),
                     1e-3 * rng.standard_normal(C),
                     1.0 + 0.2 * rng.standard_normal(C),
                     0.1 * rng.standard_normal(C),
                     0.5 + rng.random(C), 0.1 * rng.standard_normal(C)])
    vecs = torch.from_numpy(vecs.astype(np.float32))
    return [x.to(device) for x in (t(), t(), t(0.1), w, vecs)]


class FakeLibrary:
    """Stands in for the built library: records each launch's ``is_f32``
    and accepts it."""

    def __init__(self):
        self.is_f32 = []

    def f2f_bwd_layer_window(self, *args):
        self.is_f32.append(args[3])
        return 0


@pytest.fixture
def fake_launch(monkeypatch):
    lib = FakeLibrary()
    monkeypatch.setattr(fs, "_lib_bwd", lambda: lib)
    monkeypatch.setattr(fs, "_on_current_cuda", lambda name, x: None)
    monkeypatch.setattr(fs, "_partial_rows", lambda index: 2)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_device_tensor_counts_the_wgmma_body(fake_launch, dt, first):
    g, z_i, z_prev, w, vecs = inputs((1, 8, 16), dt, device="meta")
    launches = fs.bwd_layer.launches
    with torch.profiler.profile(activities=CPU_PROFILER):
        profiling.clear()
        da, dw, stats = fs.bwd_layer(g, z_i, z_prev, w, vecs, first)
        counters = profiling.recorded()["counters"]
    profiling.clear()
    assert fake_launch.is_f32 == [int(dt == torch.float32)]
    assert fs.bwd_layer.launches == launches + 1
    assert counters == {"kernel.bwd_layer.wgmma": 1}
    assert fs.BWD_BODY_COUNTER == "kernel.bwd_layer.wgmma"
    assert da.dtype == dt and tuple(da.shape) == (1, 8, 16, C)
    assert tuple(dw.shape) == (3, 3, C, C) and tuple(stats.shape) == (2, C)


def test_device_tensor_counts_nothing_without_a_profiler(fake_launch):
    g, z_i, z_prev, w, vecs = inputs((1, 8, 16), torch.bfloat16,
                                     device="meta")
    profiling.clear()
    fs.bwd_layer(g, z_i, z_prev, w, vecs)
    assert fake_launch.is_f32 == [0]
    assert profiling.recorded()["counters"] == {}


@pytest.mark.parametrize("first", [False, True])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("vb", [None, (1, 9, 2, 8)])
def test_cpu_tensor_takes_the_plain_version_and_counts_nothing(dt, first, vb):
    g, z_i, z_prev, w, vecs = inputs((2, 10, 13), dt)
    launches = fs.bwd_layer.launches
    with torch.profiler.profile(activities=CPU_PROFILER):
        profiling.clear()
        got = fs.bwd_layer(g, z_i, z_prev, w, vecs, first, valid_bounds=vb)
        counters = profiling.recorded()["counters"]
    profiling.clear()
    want = fs.bwd_layer_plain(g, z_i, z_prev, w, vecs, first,
                              valid_bounds=vb)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert fs.bwd_layer.launches == launches
    assert not [k for k in counters if k.startswith("kernel.bwd_layer")]
