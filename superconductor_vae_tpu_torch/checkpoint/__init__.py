from .from_jax import (load_params_npz, opt_state_from_jax, params_from_jax,
                       set_decoder_from_jax, train_payload_from_jax)
from .io import (ckpt_skew_transform, is_checkpoint, latest_checkpoint, load_checkpoint,
                 load_train_checkpoint, save_checkpoint, save_params_checkpoint)
from .manifest import build_manifest, check_manifest_drift
from .migrate import auto_migrate
from .ocdbt import is_orbax_snapshot, read_snapshot
