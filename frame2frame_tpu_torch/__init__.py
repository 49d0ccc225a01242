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
``conv_impl``), TV-L1 optical flow with the solver that feeds the
fine-tune, the loss family with the test-time adaptation path
(``get_loss_fxn(cfg)`` -> a wrapper ``(state, noisy, clean) -> (state,
info)``), and the harness's train-and-test path: datasets and noise
(``data.sets.load``), offline training (``train.trainer.run``) and
evaluation (``eval.test.run``).

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
           warping and occlusion masks (``warp``), the non-local search as
           a dense cost volume (``nls``), SSIM (``ssim``),
           and the flow solver's operators in plain torch ops (``grad``,
           ``gaussian``, ``interp``, ``pyramid``)
- losses:  the registry ``get_loss_fxn``; warped (frame2frame), stnls
           (``DnlsLoss``), Nb2Nb, B2U, combo, sup / n2n
- flow:    TV-L1 (``tvl1``: ``make_tvl1_solver``, ``make_batched_tvl1``,
           ``tvl1_flow``), its inner loop as one CUDA kernel with its plain
           version (``tvl1_inner``), the video API (``api``: ``run_flows``,
           ``orun``, ``precompute_flo_files``)
- train:   ``OnlineDenoiser`` (``process_frame``, ``denoise_only``,
           ``denoise_batch``), ``AsyncFlowSolver``, ``torch_adam``,
           ``run_blind_denoising``, the flat step (``flat_step``:
           ``flat_net_loss``, ``run_flat_scan``), the adaptation wrappers
           (``adapt``), ``TrainState`` (``state``), schedules and
           optimizers (``schedules``), the offline training module
           (``lit``: ``TrainModule``) and loop (``trainer.run``)
- eval:    the evaluation pipeline (``test.run``, ``measure_bwd``), x8
           self-ensemble (``aug.test_x8``), overlap-tiled inference
           (``chunks.chunk``)
- io:      ``.flo`` files, image readers and writers (numpy; PGM without
           PIL, other formats with PIL on demand), videos as directories of
           frames (``video``)
- data:    datasets (``sets.load``, ``VideoDataset``, ``synthetic_video``,
           ``filter_subseq``, ``slice_sample``, ``pack_raw_bayer``), noise
           (``noise``: Gaussian, Poisson-Gaussian, multi-scale, JPEG
           artifacts, Anscombe), ``run_rand_crop``
- cache:   sweeps of configs (``run_exps``, ``load_edata``,
           ``train_stages``): the JAX package's uuid and cache layout,
           skip-done, and the process / slurm dispatch (``dispatch``)
- cli:     ``python -m frame2frame_tpu_torch.cli.tvl1flow``,
           ``python -m frame2frame_tpu_torch.cli.blind_denoising``
- config:  ``Config``, ``optional``, ``extract_pairs``, ``dcat``,
           ``cfg_grid``, ``mesh_grids``, ``cfg_uuid``, ``ExtractConfig``
- utils:   device resolution, PSNR / SSIM / ST-RRED (``metrics``), stage
           timers and CUDA-event timing (``timer``), device memory meters
           (``mem``), seeds, slices and pickles (``misc``), ``--profile``'s
           trace, the program's spans and counters and the memory
           snapshot (``profiling``)
"""

__version__ = "0.9.0"

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


def get_loss_fxn(cfg, loss_type=None):
    """Loss registry (the reference's missing ``losses.get_loss_fxn``,
    lib/frame2frame/__init__.py:7, used at scripts/instances_adapt.py:216):
    an adaptation wrapper ``(state, noisy, clean) -> (state, info)``."""
    from . import losses

    return losses.get_loss_fxn(cfg, loss_type)
