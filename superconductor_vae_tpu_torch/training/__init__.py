from .config import TrainConfig
from .evaluate import (eval_batch, eval_generation_config, eval_train_config,
                       evaluate_autoregressive)
from .train_step import (TrainState, build_luts, check_supported,
                         clip_by_global_norm_, create_train_state, default_dyn,
                         make_optimizer, make_train_step, set_learning_rate,
                         stoich_conditioning)
from .schedulers import (EntropyManager, PerPositionEntropyWeighter, PlateauDetector,
                         RLController, rl_temperature)
