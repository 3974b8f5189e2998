from .from_jax import load_params_npz, params_from_jax
from .io import ckpt_skew_transform
