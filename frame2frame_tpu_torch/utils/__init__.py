from . import mem, metrics, misc, timer
from .mem import GpuMemer, MemIt, device_mem_gb, print_peak_gpu_stats
from .metrics import compute_psnrs, compute_ssims, compute_strred, psnr
from .misc import (
    get_region_gt,
    read_pickle,
    rslice,
    set_seed,
    slice_flows,
    write_pickle,
)
from .timer import ExpTimer, TimeIt
