"""Operations of the benchmark's models, counted from their shapes: two a
multiply-add of every convolution (BatchNorm, ReLU and the loss are left
out: they are a few operations a value beside the convolutions' 1 152).
"""

from __future__ import annotations

from .reference import fastdvdnet


def conv3x3(h, w, c_in, c_out, batch=1):
    """A 3x3 convolution's operations at an output of ``h`` x ``w``."""
    return 2 * 9 * c_in * c_out * h * w * batch


def dncnn_forward(h, w, channels=1, features=64, nmid=15, batch=1):
    """One DnCNN forward: the first layer, ``nmid`` mid layers, the last."""
    return (conv3x3(h, w, channels, features, batch)
            + nmid * conv3x3(h, w, features, features, batch)
            + conv3x3(h, w, features, channels, batch))


def dncnn_finetune_frame(h, w, iters, channels=1, features=64, nmid=15):
    """A fine-tuned frame: ``iters`` updates of a forward and its backward
    (the input's and the weights' gradients, each as many operations as the
    forward), then one eval forward."""
    fwd = dncnn_forward(h, w, channels, features, nmid)
    return (3 * iters + 1) * fwd


def fastdvdnet_window(h, w, channels=3):
    """One 5-frame window: stage 1 three times, stage 2 once."""
    block = sum(conv3x3(-(-h // lev), -(-w // lev), ci, co)
                for _, ci, co, lev in fastdvdnet.layout(channels))
    return 4 * block


def fastdvdnet_video(h, w, frames, channels=3):
    """A video of ``frames`` frames, a window a frame."""
    return frames * fastdvdnet_window(h, w, channels)
