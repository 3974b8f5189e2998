from .evaluate import eval_batch, eval_generation_config
from .train_step import build_luts, stoich_conditioning
