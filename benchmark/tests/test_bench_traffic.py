"""The traffic generators repeat for a seed: the same seed gives the same
frames, another seed other frames of the same sizes and motion."""

import numpy as np
import torch

from benchmark import scene
from benchmark.runners import finetune

CPU = torch.device("cpu")
BIG = 2**31 + 12345  # a run's seed may pass 32 signed bits


def test_scene_repeats_for_a_seed():
    a = scene.moving(3, 24, 40, BIG, CPU)
    b = scene.moving(3, 24, 40, BIG, CPU)
    c = scene.moving(3, 24, 40, BIG + 1, CPU)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a[1].shape == c[1].shape == (3, 24, 40, 1)
    assert not torch.equal(a[1], c[1])


def test_scene_moves_by_the_stated_displacement():
    clean, noisy = scene.moving(2, 64, 96, 7, CPU, sigma=0.1)
    assert float(clean.min()) >= 0.1 - 1e-6 and float(clean.max()) <= 0.9
    # away from the faster rectangle, frame 1 at p is frame 0 at
    # p + (0.6, -0.4 + wave): the textures agree to interpolation error
    diff = (clean[1] - clean[0]).abs().mean()
    assert 0 < float(diff) < 0.2
    noise = (noisy - clean).std()
    assert abs(float(noise) - 0.1) < 0.01


def test_rgb_channels_are_neighbouring_frames():
    grey, _ = scene.moving(4, 16, 24, 3, CPU)
    rgb, _ = scene.moving(2, 16, 24, 3, CPU, channels=3)
    # the same scene, normalised over its own frames: compare the motion
    assert rgb.shape == (2, 16, 24, 3)
    assert torch.allclose(rgb[0, ..., 1], rgb[1, ..., 0])


def test_stream_plays_forward_and_back():
    seq = [finetune.pingpong(i, 4) for i in range(10)]
    assert seq == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]
    assert all(abs(a - b) == 1 for a, b in zip(seq, seq[1:]))


def test_the_optimizer_vector_unravels_to_the_module_layout():
    from frame2frame_tpu_torch.models.dncnn import DnCNN, JaxRavel

    model = DnCNN(num_layers=5)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p))
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()
              if "num_batches" not in k}
    got = finetune.unravel(JaxRavel(model).ravel(), shapes)
    for name, p in model.named_parameters():
        assert torch.equal(got[name], p.detach()), name
    assert np.prod(list(got["conv_in.weight"].shape)) == 9 * 64
