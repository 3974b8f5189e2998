from .config import TrainConfig
from .evaluate import (eval_batch, eval_generation_config, eval_train_config,
                       evaluate_autoregressive)
from .train_step import (MultiSteps, TrainState, build_luts,
                         clip_by_global_norm_, create_train_state, default_dyn,
                         make_epoch_runner, make_optimizer, make_set_decoder,
                         make_train_step, set_learning_rate, stoich_conditioning)
from .schedulers import (DropDetector, EntropyManager, LossSkipScheduler,
                         PerPositionEntropyWeighter, PhysZController, PlateauDetector,
                         RLController, TcBinTracker, cosine_lr, curriculum_weights,
                         rl_temperature, teacher_forcing_ratio)
from .self_supervised import (NovelDiscoveryTracker, Phase2Config, SelfSupervisedEpoch,
                              phase2_seed)
from .train_loop import train
