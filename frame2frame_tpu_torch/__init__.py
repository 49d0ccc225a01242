"""frame2frame_tpu_torch: the PyTorch + CUDA port of frame2frame_tpu for
NVIDIA Hopper.

It imports torch, numpy and the standard library only; never JAX, flax or
``frame2frame_tpu``. Ported so far: the DnCNN serving path and the online
fine-tune.

- models:  DnCNN module + weight and optimizer-state converters, msgpack
           checkpoint reader, the fused eval and training forwards
           (``fused_apply``)
- ops:     hand-written CUDA kernels with their plain PyTorch versions and
           the differentiable mid stack (``fused_stack``), their build
           (``_build``), flow warping and occlusion masks (``warp``)
- train:   ``OnlineDenoiser`` (``process_frame``, ``denoise_only``,
           ``denoise_batch``), ``torch_adam``
- utils:   device resolution, PSNR, CUDA-event timing
"""

__version__ = "0.2.0"
