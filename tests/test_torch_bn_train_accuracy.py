"""The DnCNN's f32 training-mode BatchNorm (``models/dncnn._bn_f32``)
against the same BatchNorm in float64, on the CPU, on one thread.

The case is the activations of one f2f adaptation window with
``adapt_train_bn=True`` (``scripts/torch_adapt_f2f_distance.py``): five
96x128 frames, 64 channels, NHWC, 61 440 values a channel. PyTorch's CPU
``batch_norm`` on a channels-last view accumulates a channel's statistics
in f32 one value after another, which left the normalised output 4e-5 from
float64 (on one thread; less on more threads) and the port's train-mode
window 8 times farther from float64 than the JAX package's; on a contiguous
NCHW tensor its reductions hold the output within 6e-7. Held: the output
within ``Y_ATOL`` of float64, and the gradients of ``sum(y * g)`` with
respect to the input, the scale and the bias within ``GRAD_RTOL`` of their
largest float64 value.
"""

import pytest

torch = pytest.importorskip("torch")

from frame2frame_tpu_torch.models.dncnn import _bn_f32  # noqa: E402

Y_ATOL = 2e-6
GRAD_RTOL = 1e-5


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_batch_norm_matches_float64(one_thread):
    gen = torch.Generator().manual_seed(0)
    z = torch.randn(5, 96, 128, 64, generator=gen) * 0.3 + 0.7
    g = torch.randn(z.shape, generator=gen)
    bn = torch.nn.BatchNorm2d(64)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.2 * torch.randn(64, generator=gen))
        bn.bias.copy_(0.1 * torch.randn(64, generator=gen))
    out = {}
    for dt in (torch.float32, torch.float64):
        b = bn.to(dt)
        b.zero_grad()
        x = z.to(dt).clone().requires_grad_()
        y, (mean, var) = _bn_f32(b, x, True)
        (y * g.to(dt)).sum().backward()
        out[dt] = [t.detach().double() for t in (y, x.grad, b.weight.grad,
                                                  b.bias.grad, mean, var)]
    (y32, *g32), (y64, *g64) = out[torch.float32], out[torch.float64]
    assert float((y32 - y64).abs().max()) <= Y_ATOL
    for a, r in zip(g32, g64):
        assert float((a - r).abs().max()) <= GRAD_RTOL * float(r.abs().max())
