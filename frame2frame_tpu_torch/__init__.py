"""frame2frame_tpu_torch: the PyTorch + CUDA port of frame2frame_tpu for
NVIDIA Hopper.

It imports torch, numpy and the standard library only; never JAX, flax or
``frame2frame_tpu``. Ported so far: the DnCNN serving path, the online
fine-tune on both of the JAX package's routes (the whole-iteration flat
step, which the engine takes where it is eligible, and the per-iteration
body on ``fused_train_apply``), and TV-L1 optical flow with the solver that
feeds the fine-tune.

- models:  DnCNN module + weight and optimizer-state converters, msgpack
           checkpoint reader, the fused eval and training forwards
           (``fused_apply``)
- ops:     hand-written CUDA kernels with their plain PyTorch versions: the
           mid layers and the differentiable mid stack (``fused_stack``,
           which also keeps the launch registry of all nine kernels), the
           two ends of the network with the loss (``fused_ends``), their
           build (``_build``), flow warping and occlusion masks (``warp``),
           and the flow solver's operators in plain torch ops (``grad``,
           ``gaussian``, ``interp``, ``pyramid``)
- flow:    TV-L1 (``tvl1``: ``make_tvl1_solver``, ``make_batched_tvl1``,
           ``tvl1_flow``), its inner loop as one CUDA kernel with its plain
           version (``tvl1_inner``), the video API (``api``: ``run_flows``,
           ``orun``, ``precompute_flo_files``)
- train:   ``OnlineDenoiser`` (``process_frame``, ``denoise_only``,
           ``denoise_batch``), ``AsyncFlowSolver``, ``torch_adam``, the flat
           step (``flat_step``: ``flat_net_loss``, ``run_flat_scan``)
- io:      ``.flo`` files, image readers and writers (numpy, PIL on demand)
- cli:     ``python -m frame2frame_tpu_torch.cli.tvl1flow``
- config:  ``Config``
- utils:   device resolution, PSNR, CUDA-event timing
"""

__version__ = "0.4.0"
