"""frame2frame_tpu_torch: the PyTorch + CUDA port of frame2frame_tpu for
NVIDIA Hopper.

It imports torch, numpy and the standard library only; never JAX, flax or
``frame2frame_tpu``. Ported so far: the DnCNN serving path.

- models:  DnCNN module + weight converters, msgpack checkpoint reader, the
           fused eval forward (``fused_apply``)
- ops:     hand-written CUDA kernels with their plain PyTorch versions
           (``fused_stack``), and their build (``_build``)
- train:   ``OnlineDenoiser`` serving entry points (``denoise_only``,
           ``denoise_batch``)
- utils:   device resolution, PSNR, CUDA-event timing
"""

__version__ = "0.1.0"
