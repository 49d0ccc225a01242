"""The port's x8 self-ensemble and chunked inference
(``frame2frame_tpu_torch/eval/aug.py``, ``eval/chunks.py``) against the JAX
package's, on the CPU.

- ``test_x8`` on square and rectangular frames, with a forward that is not
  equivariant (a position ramp and a cumulative sum) and with a 4-layer
  DnCNN, within 1e-6 of the largest value; the variants grouped as JAX
  groups them (one call for a square frame, [0, 2, 5, 7] then
  [1, 3, 4, 6] for a rectangle);
- ``chunk`` with spatial tiles, temporal chunks with overlap, both, and
  flows handed to the tiles, within 1e-6 of the largest value;
- the call form (``fwd(vid, flows)`` or ``fwd(vid)``) is read from the
  signature: a ``TypeError`` raised inside the forward reaches the caller,
  after one call.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.eval import aug as jaug  # noqa: E402
from frame2frame_tpu.eval import chunks as jchunks  # noqa: E402
from frame2frame_tpu.models.dncnn import DnCNN as JDnCNN  # noqa: E402
from frame2frame_tpu_torch.eval import aug as taug  # noqa: E402
from frame2frame_tpu_torch.eval import chunks as tchunks  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import init_dncnn  # noqa: E402

from test_torch_nls import one_torch_thread  # noqa: E402,F401

RTOL = 1e-6


def ramp_fwd(xp):
    """A forward that is neither rotation- nor transpose-equivariant, in
    numpy-style ops of ``xp`` (jnp or torch)."""
    def fwd(vid, flows=None):
        H, W = vid.shape[-3], vid.shape[-2]
        ramp = (xp.arange(H * W, dtype=vid.dtype) / (H * W)).reshape(H, W, 1)
        out = vid * vid * (1 + ramp) + 0.1 * xp.cumsum(vid, -2)
        if flows is not None:
            out = out + 0.01 * flows["fflow"][..., :1]
        return out
    return fwd


def hold(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if hasattr(got, "detach") else got
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.fixture(scope="module")
def dncnn():
    """A 4-layer grayscale DnCNN, the port's module and JAX's on its
    weights, each as a forward (B, T, H, W, C) -> (B, T, H, W, C)."""
    port, variables = init_dncnn(0, channels=1, num_layers=4, residual=True,
                                 conv_impl="xla")
    port.eval()
    model = JDnCNN(channels=1, num_layers=4, residual=True, conv_impl="xla")

    def jfwd(vid, flows=None):
        out = model.apply(variables, vid.reshape((-1,) + vid.shape[2:]),
                          train=False)
        return out.reshape(vid.shape)

    def tfwd(vid, flows=None):
        with torch.no_grad():
            return port(vid.reshape((-1,) + vid.shape[2:])).reshape(vid.shape)

    return jfwd, tfwd


@pytest.mark.parametrize("hw", [(12, 12), (12, 20)])
@pytest.mark.parametrize("net", ["ramp", "dncnn"])
def test_x8(hw, net, dncnn):
    vid = np.random.default_rng(1).random((2, 2) + hw + (1,)).astype(
        np.float32)
    jfwd, tfwd = ((ramp_fwd(jnp), ramp_fwd(torch)) if net == "ramp"
                  else dncnn)
    want = jaug.test_x8(jfwd, jnp.asarray(vid))
    calls = []

    def counted(v, fl=None):
        calls.append(tuple(v.shape))
        assert fl is None
        return tfwd(v, fl)

    got = taug.test_x8(counted, torch.from_numpy(vid))
    hold(got, want)
    H, W = hw
    if H == W:
        assert calls == [(16, 2, H, W, 1)]
    else:
        # [0, 2, 5, 7] keep the frame's shape, [1, 3, 4, 6] swap it
        assert calls == [(8, 2, H, W, 1), (8, 2, W, H, 1)]


def test_x8_transforms_invert():
    vid = torch.arange(2 * 3 * 4 * 5 * 2, dtype=torch.float32).reshape(
        2, 3, 4, 5, 2)
    for i in range(8):
        t = taug._transform(vid, i)
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(jaug._transform(jnp.asarray(vid), i)))
        assert torch.equal(taug._inverse(t, i), vid)


CHUNK_CFGS = {
    "spatial": dict(spatial_chunk_size=8, spatial_chunk_overlap=0.25),
    "temporal": dict(temporal_chunk_size=2, temporal_chunk_overlap=1),
    "both": dict(spatial_chunk_size=10, spatial_chunk_overlap=0.5,
                 temporal_chunk_size=3, temporal_chunk_overlap=1),
    "larger": dict(spatial_chunk_size=64),
}


@pytest.mark.parametrize("name", sorted(CHUNK_CFGS))
@pytest.mark.parametrize("with_flows", [False, True])
def test_chunk(name, with_flows):
    rng = np.random.default_rng(2)
    vid = rng.random((1, 5, 18, 22, 1)).astype(np.float32)
    fl = {k: rng.standard_normal((1, 5, 18, 22, 2)).astype(np.float32)
          for k in ("fflow", "bflow")}
    cfg = CHUNK_CFGS[name]
    jflows = {k: jnp.asarray(v) for k, v in fl.items()} if with_flows else None
    tflows = ({k: torch.from_numpy(v) for k, v in fl.items()}
              if with_flows else None)
    want = jchunks.chunk(cfg, ramp_fwd(jnp))(jnp.asarray(vid), jflows)
    got = tchunks.chunk(cfg, ramp_fwd(torch))(torch.from_numpy(vid), tflows)
    hold(got, want)


def test_chunk_one_argument_forward():
    """A forward without a flows argument gets the tile alone."""
    vid = np.random.default_rng(3).random((1, 3, 12, 12, 1)).astype(
        np.float32)
    cfg = CHUNK_CFGS["both"]
    want = jchunks.chunk(cfg, lambda v: v * 2 + 1)(jnp.asarray(vid))
    got = tchunks.chunk(cfg, lambda v: v * 2 + 1)(torch.from_numpy(vid))
    hold(got, want)
    got = taug.test_x8(lambda v: v * 2 + 1, torch.from_numpy(vid))
    hold(got, jaug.test_x8(lambda v: v * 2 + 1, jnp.asarray(vid)))


def test_chunk_without_sizes_is_the_forward():
    def fwd(v, fl=None):
        return v

    assert tchunks.chunk({}, fwd) is fwd
    assert tchunks.extract_chunks_config({"spatial_chunk_size": 4}) == dict(
        spatial_chunk_size=4, spatial_chunk_overlap=0.0,
        temporal_chunk_size=0, temporal_chunk_overlap=0)


@pytest.mark.parametrize("wrap", ["chunk", "test_x8"])
def test_type_error_inside_reaches_the_caller(wrap):
    """JAX's wrappers catch a ``TypeError`` to find the call form, and so
    call a forward that raised one again without flows; the port's read the
    form from the signature, and the error inside reaches the caller."""
    calls = []

    def fwd(vid, flows=None):
        calls.append(flows)
        raise TypeError("inside the forward")

    vid = torch.zeros((1, 2, 8, 8, 1))
    run = (tchunks.chunk(CHUNK_CFGS["spatial"], fwd) if wrap == "chunk"
           else lambda v: taug.test_x8(fwd, v))
    with pytest.raises(TypeError, match="inside the forward"):
        run(vid)
    assert len(calls) == 1
