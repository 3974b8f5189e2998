"""The weight bridge on the committed run4 checkpoint: the Orbax snapshot
(bf16 params) read by the JAX package loads strictly into the port's
modules, and the encoder gives the JAX encoder's outputs on real rows;
the snapshot's ``set_params`` load into the port's ``SetFormulaDecoder``,
which gives flax's outputs on those rows' latents.

Tolerance: both run in float32 from the same bf16-valued weights; 1e-4
absolute and relative for the 2048-wide latent, the heads and the set
decoder's outputs."""

from pathlib import Path

import jax
import numpy as np
import torch

from superconductor_vae_tpu.checkpoint import load_checkpoint
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.models.config import ModelConfig as JaxConfig
from superconductor_vae_tpu.training.config import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu.training.train_step import make_set_decoder as jax_set_decoder
from superconductor_vae_tpu_torch.checkpoint import params_from_jax
from superconductor_vae_tpu_torch.data import composition_slots, read_csv_rows
from superconductor_vae_tpu_torch.models import config_from_meta

import torch_port_threads  # noqa: F401  (one torch thread a process)

ROOT = Path(__file__).resolve().parents[1]


def test_run4_snapshot_loads_into_the_port():
    restored, meta = load_checkpoint(ROOT / 'results/run4/ckpt_snapshot')
    enc_np = jax.tree.map(np.asarray, restored['enc_params'])
    dec_np = jax.tree.map(np.asarray, restored['dec_params'])
    cfg = config_from_meta(meta['model_config'])
    set_np = jax.tree.map(np.asarray, restored['set_params'])
    encoder, decoder, set_dec = params_from_jax(enc_np, dec_np, cfg, device='cpu',
                                                set_params=set_np)
    n = sum(p.numel() for m in (encoder, decoder, set_dec) for p in m.parameters())
    n_jax = sum(x.size for x in jax.tree.leaves((enc_np, dec_np, set_np)))
    assert n == n_jax

    rows = read_csv_rows(ROOT / 'data/processed/jarvis_merged.csv.gz', 2)
    idx, frac, mask = composition_slots(rows['formula'])
    magpie = np.nan_to_num(rows['magpie']) / 100.0     # any finite input
    tc = np.log1p(rows['tc']).astype(np.float32)
    f32 = jax.tree.map(lambda x: np.asarray(x, np.float32), restored['enc_params'])
    want = jax.jit(JaxEncoder(JaxConfig(**meta['model_config'])).apply)(
        f32, idx, frac, mask, magpie, tc)
    with torch.no_grad():
        got = encoder(torch.as_tensor(idx).long(), torch.as_tensor(frac),
                      torch.as_tensor(mask), torch.as_tensor(magpie),
                      torch.as_tensor(tc))
    for key in ('z', 'tc_pred', 'sc_pred', 'family_composed_14', 'fraction_pred'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4)

    # the set decoder, as the JAX train step builds it, on those latents
    z = np.asarray(want['z'])
    jset = jax_set_decoder(JaxConfig(**meta['model_config']), JaxTrainConfig())
    want_set = jax.jit(jset.apply)(
        jax.tree.map(lambda x: np.asarray(x, np.float32), restored['set_params']), z)
    with torch.no_grad():
        got_set = set_dec(torch.as_tensor(z))
    for key in ('element_logits', 'fraction_pred', 'presence_logits'):
        np.testing.assert_allclose(got_set[key].numpy(), np.asarray(want_set[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)
