"""frame2frame_tpu_torch: the PyTorch + CUDA port of frame2frame_tpu for
NVIDIA Hopper.

It imports torch, numpy, scipy (the quality metrics) and the standard
library only; never JAX, flax or ``frame2frame_tpu``. Ported so far: the
config-driven model entry point (``load_model(cfg)`` -> ``apply(vid)``, with
DnCNN and FastDVDnet; a ``"fused"`` DnCNN serves its batches on the fused
kernels on a card), the noise simulator, the host helpers the harness stands
on (configs and their grids, metrics, timers, memory meters, video I/O,
random crops), the streaming loop
(``run_blind_denoising`` and the ``blind_denoising`` CLI), the DnCNN serving
path, the online fine-tune on the JAX package's routes (the whole-iteration
flat step, which the engine takes where it is eligible, the per-iteration
body on ``fused_train_apply``, and the module's own forward for every
``conv_impl``), and TV-L1 optical flow with the solver that feeds the
fine-tune.

- models:  the registry (``load_model``, ``extract_model_config``,
           ``load_checkpoint``), DnCNN module with its ``conv_impl`` routes
           and ``init_dncnn`` + weight and optimizer-state converters,
           FastDVDnet (``fastdvdnet``: ``FastDVDnet``, ``FastDVDnetVideo``,
           ``init_fastdvdnet``, the official state-dict layout and the JAX
           converters), the noise simulator (``noise_sim``:
           ``HeteroscedasticGaussianSim``, ``load_sim``), msgpack checkpoint
           reader and writer (``load_variables(like=)``,
           ``save_train_state(extra=)``, ``load_train_state``), the fused
           eval and training forwards (``fused_apply``)
- ops:     hand-written CUDA kernels with their plain PyTorch versions: the
           mid layers and the differentiable mid stack (``fused_stack``,
           which also keeps the launch registry of all eleven kernels), the
           two ends of the network with the loss (``fused_ends``), the f32
           3x3 convolution and its weight gradient of the ``conv_impl``
           routes (``conv3x3``, ``conv_dw``), their build (``_build``) and
           the library convolutions with TF32 off (``_common``), flow
           warping and occlusion masks (``warp``),
           and the flow solver's operators in plain torch ops (``grad``,
           ``gaussian``, ``interp``, ``pyramid``)
- flow:    TV-L1 (``tvl1``: ``make_tvl1_solver``, ``make_batched_tvl1``,
           ``tvl1_flow``), its inner loop as one CUDA kernel with its plain
           version (``tvl1_inner``), the video API (``api``: ``run_flows``,
           ``orun``, ``precompute_flo_files``)
- train:   ``OnlineDenoiser`` (``process_frame``, ``denoise_only``,
           ``denoise_batch``), ``AsyncFlowSolver``, ``torch_adam``,
           ``run_blind_denoising``, the flat step (``flat_step``:
           ``flat_net_loss``, ``run_flat_scan``)
- io:      ``.flo`` files, image readers and writers (numpy; PGM without
           PIL, other formats with PIL on demand), videos as directories of
           frames (``video``)
- data:    ``run_rand_crop``
- cli:     ``python -m frame2frame_tpu_torch.cli.tvl1flow``,
           ``python -m frame2frame_tpu_torch.cli.blind_denoising``
- config:  ``Config``, ``optional``, ``extract_pairs``, ``dcat``,
           ``cfg_grid``, ``mesh_grids``, ``cfg_uuid``, ``ExtractConfig``
- utils:   device resolution, PSNR / SSIM / ST-RRED (``metrics``), stage
           timers and CUDA-event timing (``timer``), device memory meters
           (``mem``), seeds, slices and pickles (``misc``), ``--profile``'s
           trace, named regions and memory snapshot (``profiling``)
"""

__version__ = "0.6.0"

from . import config
from .config import Config, cfg_grid, dcat, extract_pairs, optional


def load_model(cfg, device=None):
    """Config-driven model construction (reference
    lib/frame2frame/__init__.py:31-39) on ``device`` (None: the CUDA card)."""
    from . import models

    return models.load_model(cfg, device=device)


def extract_model_config(cfg):
    from . import models

    return models.extract_model_config(cfg)
