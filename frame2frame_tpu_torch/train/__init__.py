from .adapt import WrapDnlsLoss, WrapSupLoss, WrapWarpedLoss
from .lit import TrainModule, init_cfg, lit_pairs
from .online import OnlineDenoiser, make_online_step, run_blind_denoising, torch_adam
from .schedules import make_optimizer, make_schedule
from .state import TrainState, apply_gradients
from . import trainer
