from .from_jax import load_params_npz, params_from_jax, set_decoder_from_jax
from .io import ckpt_skew_transform, latest_checkpoint, load_checkpoint, save_checkpoint
from .manifest import build_manifest, check_manifest_drift
from .migrate import auto_migrate
