"""frame2frame_tpu_torch: the PyTorch + CUDA port of frame2frame_tpu for
NVIDIA Hopper.

It imports torch, numpy and the standard library only; never JAX, flax or
``frame2frame_tpu``. Ported so far: the DnCNN serving path and the online
fine-tune, on both of the JAX package's routes (the whole-iteration flat
step, which the engine takes where it is eligible, and the per-iteration
body on ``fused_train_apply``).

- models:  DnCNN module + weight and optimizer-state converters, msgpack
           checkpoint reader, the fused eval and training forwards
           (``fused_apply``)
- ops:     hand-written CUDA kernels with their plain PyTorch versions: the
           mid layers and the differentiable mid stack (``fused_stack``,
           which also keeps the launch registry of all eight kernels), the
           two ends of the network with the loss (``fused_ends``), their
           build (``_build``), flow warping and occlusion masks (``warp``)
- train:   ``OnlineDenoiser`` (``process_frame``, ``denoise_only``,
           ``denoise_batch``), ``torch_adam``, the flat step
           (``flat_step``: ``flat_net_loss``, ``run_flat_scan``)
- utils:   device resolution, PSNR, CUDA-event timing
"""

__version__ = "0.3.0"
