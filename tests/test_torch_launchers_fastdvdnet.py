"""The port's FastDVDnet launchers (``scripts/torch_trte_net/{train,
test}.py``) against the JAX package's (``scripts/trte_net/``), on the CPU,
as ``tests/test_torch_launchers.py`` holds the DnCNN launchers: FastDVDnet
at its published widths on two 2-frame clips, trained one epoch at 32x32
and served at 16x16, from one checkpoint, ``val_psnr`` and every frame's
PSNR within 1e-3 dB of JAX's.

The training runs Adam at 1e-6. FastDVDnet's f32 gradient at 32x32 lies
1.4 % from float64 (BatchNorm over the 64 pixels of an 8x8 level;
``tests/test_torch_fastdvdnet.py``), in each package on its own, and
Adam's first step turns that into a whole step of opposite sign for 2.4 %
of the weights: at 1e-4 the two packages' ``val_psnr`` lie 0.03 dB apart
(0.03 dB too with SGD at 1e-3). At 1e-6 the training still moves
``val_psnr`` 7.3e-3 dB from a zero-rate run (held at 5e-3 dB in
``train_launcher``) and the packages' spread stays under 1e-5 dB. The JAX trainer's jit
compile takes most of this file's time.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_launchers import (  # noqa: E402,F401
    ckpts,
    eval_launcher,
    jax_dataset_draws,
    one_torch_thread,
    train_launcher,
)


def test_train_launcher_matches_jax(ckpts, tmp_path, monkeypatch):  # noqa: F811
    train_launcher(ckpts, tmp_path, monkeypatch, "fastdvdnet",
                   dict(nframes_data=2, isize_data=[16, 16]))


def test_test_launcher_matches_jax(ckpts, tmp_path, monkeypatch):  # noqa: F811
    eval_launcher(ckpts, tmp_path, monkeypatch, "fastdvdnet",
                  dict(nframes_data=2, isize_data=[16, 16]))
