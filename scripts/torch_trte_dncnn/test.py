"""Offline DnCNN evaluation launcher of the PyTorch port, the twin of
``scripts/trte_dncnn/test.py``: evaluates each config of
``exps/trte_dncnn/test.cfg`` through ``eval.test.run`` and prints each run's
mean PSNR, cached under ``.cache_f2f_torch/trte_dncnn_te``
(``frame2frame_tpu_torch/cache/launch.py``).

    python scripts/torch_trte_dncnn/test.py [--dispatch process|slurm]
        [--wandb] [--device cpu|cuda|cuda:N]

Without ``--device`` the runs take the CUDA card; on a host without one,
pass ``--device cpu`` (``main(device="cpu")`` from Python).
"""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from frame2frame_tpu_torch.cache import launch  # noqa: E402

CFG = REPO / "exps" / "trte_dncnn" / "test.cfg"


def main(enable_dispatch=None, use_wandb=False, device=None, cfg_path=CFG):
    return launch.test(cfg_path, "trte_dncnn_te", enable_dispatch, use_wandb,
                       device)


if __name__ == "__main__":
    launch.cli(main)
