"""Shared set-up of the parity tests between the JAX package and its
PyTorch port (tests/test_torch_port_*.py).

Parameters are numpy trees of the flax models' shapes (taken with
``jax.eval_shape``, which compiles nothing), filled from
``np.random.default_rng(seed)``; the same trees drive the JAX model and,
through ``params_from_jax``, the port.  Inputs come from numpy too.

Run as a script, it exports an Orbax snapshot's params to an npz file,
which the port's CLIs take with ``--params`` (they also read the snapshot
itself, with ``--checkpoint``):

    PYTHONPATH=. python tests/torch_port_common.py results/run4/ckpt_snapshot \
        build/run4_params.npz
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from superconductor_vae_tpu.models import FormulaDecoder as JaxDecoder
from superconductor_vae_tpu.models import MaterialsEncoder as JaxEncoder
from superconductor_vae_tpu.models.config import ModelConfig as JaxConfig
from superconductor_vae_tpu.models.set_decoder import SetFormulaDecoder as JaxSetDecoder
from superconductor_vae_tpu.training.config import TrainConfig as JaxTrainConfig
from superconductor_vae_tpu_torch.checkpoint import params_from_jax
from superconductor_vae_tpu_torch.models import ModelConfig


def jax_config(cfg: ModelConfig) -> JaxConfig:
    return JaxConfig(**dataclasses.asdict(cfg))


def _fill(tree, rng: np.random.Generator):
    """Weights scaled so activations stay O(1) at any width."""
    def leaf(path, s):
        name = path[-1].key
        if name == 'kernel':
            return (rng.standard_normal(s.shape) / np.sqrt(s.shape[0])).astype(np.float32)
        if name == 'scale':
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == 'query':
            return (rng.standard_normal(s.shape) / np.sqrt(s.shape[1])).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def param_trees(cfg: ModelConfig, seed: int = 0):
    """Random (enc_params, dec_params) numpy trees of the flax models."""
    jcfg = jax_config(cfg)
    b, key = 2, jax.random.PRNGKey(0)
    enc_shapes = jax.eval_shape(
        JaxEncoder(jcfg).init, key, jnp.zeros((b, cfg.max_elements), jnp.int32),
        jnp.zeros((b, cfg.max_elements)), jnp.zeros((b, cfg.max_elements), bool),
        jnp.zeros((b, cfg.magpie_dim)), jnp.zeros((b,)))
    dec_shapes = jax.eval_shape(
        JaxDecoder(jcfg).init, key, jnp.zeros((b, cfg.latent_dim)),
        jnp.zeros((b, cfg.max_len), jnp.int32),
        jnp.zeros((b, cfg.stoich_input_dim)), jnp.zeros((b, cfg.heads_input_dim)))
    rng = np.random.default_rng(seed)
    return _fill(enc_shapes, rng), _fill(dec_shapes, rng)


def set_param_tree(latent_dim: int, seed: int = 2, **kw):
    """A random numpy tree of the flax ``SetFormulaDecoder(latent_dim,
    **kw)``'s shapes."""
    shapes = jax.eval_shape(JaxSetDecoder(latent_dim=latent_dim, **kw).init,
                            jax.random.PRNGKey(0), jnp.zeros((2, latent_dim)))
    return _fill(shapes, np.random.default_rng(seed))


def fix_rollout_heads(trees):
    """Random heads end most rollouts at their first step (hard stop or a
    predicted EOS type); a constant stop probability of 0.018 and a type
    head that never predicts EOS let them run (chip_smoke.py's
    ``fix_rollout_heads``, on the numpy trees).  Returns ``trees``."""
    dec = trees[1]['params']
    dec['stop_d2']['kernel'][:] = 0.0
    dec['stop_d2']['bias'][:] = -4.0
    dec['type_d3']['bias'][4] = -30.0
    return trees

def batch(cfg: ModelConfig, b: int, seed: int = 1):
    """A numpy eval batch: element slots, magpie, tc and target tokens."""
    rng = np.random.default_rng(seed)
    n_el = rng.integers(1, cfg.max_elements + 1, b)
    mask = np.arange(cfg.max_elements)[None, :] < n_el[:, None]
    frac = rng.random((b, cfg.max_elements)).astype(np.float32) * mask
    frac = (frac / frac.sum(axis=1, keepdims=True)).astype(np.float32)
    return {
        'element_indices': (rng.integers(1, cfg.n_elements + 1,
                                         (b, cfg.max_elements)) * mask).astype(np.int32),
        'element_fractions': frac,
        'element_mask': mask,
        'magpie': rng.standard_normal((b, cfg.magpie_dim)).astype(np.float32),
        'tc': rng.standard_normal(b).astype(np.float32),
        'tokens': rng.integers(0, cfg.vocab_size, (b, cfg.max_len)).astype(np.int32),
    }


def to_torch(batch_np):
    return {k: torch.as_tensor(v).long() if v.dtype == np.int32 else torch.as_tensor(v)
            for k, v in batch_np.items()}


def port_models(cfg: ModelConfig, trees):
    """The port's encoder and decoder on the CPU, loaded from ``trees``."""
    return params_from_jax(trees[0], trees[1], cfg, device='cpu')


def save_tiny_snapshot(root: Path, cfg: ModelConfig, seed: int = 3) -> Path:
    """An Orbax snapshot written by the JAX package's save_checkpoint under
    ``root``: ``param_trees(cfg, seed)`` with the encoder's params in bf16
    (run4's snapshots hold bf16) and the decoder's in float32, optimizer
    states of AdamW's shape (a count, then moments like the params; numpy,
    so nothing compiles), the step, and mastery arrays (float64, bool).
    Returns its directory (``meta.json`` and ``state/``)."""
    from superconductor_vae_tpu.checkpoint import save_checkpoint
    enc, dec = param_trees(cfg, seed=seed)
    enc = jax.tree.map(lambda x: x.astype(jnp.bfloat16), enc)

    def adamw(tree):
        return (np.zeros((), np.int32), jax.tree.map(np.zeros_like, tree),
                jax.tree.map(np.ones_like, tree))
    state = types.SimpleNamespace(step=np.int32(7), enc_params=enc, dec_params=dec,
                                  enc_opt=adamw(enc), dec_opt=adamw(dec))
    mastery = {'mastery': np.linspace(0, 1, 48), 'seen': np.arange(48) % 3 == 0}
    return save_checkpoint(root, state, jax_config(cfg), JaxTrainConfig(), 5,
                           extra_arrays={'mastery': mastery})


def head_csv(src: Path, out: Path, n: int) -> Path:
    """The first ``n`` rows of the gzipped CSV ``src`` (and its header) as ``out``."""
    with gzip.open(src, 'rt') as f:
        out.write_text(''.join(next(f) for _ in range(n + 1)))
    return out


def export_params_npz(restored, out_path):
    """A restored snapshot's (``load_checkpoint``) encoder, decoder and,
    where it has one, set decoder params as float32 arrays (exact for its
    bf16 values), keyed by ``enc_params/``, ``dec_params/`` or
    ``set_params/`` and the leaf's ``/``-joined path, for the port's
    ``load_params_npz``."""
    flat = {}
    for root in ('enc_params', 'dec_params', 'set_params'):
        if restored.get(root) is None:
            continue
        for path, leaf in jax.tree_util.tree_flatten_with_path(restored[root])[0]:
            flat['/'.join([root] + [k.key for k in path])] = np.asarray(leaf, np.float32)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, **flat)



class FedDraws:
    """The port's random draws, recorded and fed to the JAX package.

    ``recording()`` wraps ``torch.randint`` / ``torch.rand`` /
    ``torch.randn`` and keeps each result by kind; ``feeding(mp, *modules)``
    replaces the ``jax`` of each JAX module with a stand-in whose
    ``jax.random.randint`` / ``uniform`` / ``normal`` return those draws in
    the order of their kind (``uniform`` as ``minval + (maxval - minval) *
    u`` in float32, the port's arithmetic), and fails if a shape or a
    count differs.  Everything else is JAX's own.  Draws inside a
    ``jax.jit`` are taken once, at tracing: run such code under
    ``jax.disable_jit()``."""

    KINDS = {'randint': 'randint', 'rand': 'uniform', 'randn': 'normal'}

    def __init__(self):
        self.queues = {k: [] for k in self.KINDS.values()}

    @contextlib.contextmanager
    def recording(self):
        real = {name: getattr(torch, name) for name in self.KINDS}

        def wrap(name):
            def draw(*args, **kwargs):
                out = real[name](*args, **kwargs)
                self.queues[self.KINDS[name]].append(out.detach().cpu().numpy())
                return out
            return draw
        try:
            for name in real:
                setattr(torch, name, wrap(name))
            yield self
        finally:
            for name, fn in real.items():
                setattr(torch, name, fn)

    def _next(self, kind, shape):
        assert self.queues[kind], f'JAX draws more {kind} values than the port'
        v = self.queues[kind].pop(0)
        assert v.shape == tuple(shape), (kind, v.shape, shape)
        return v

    def exhausted(self) -> bool:
        return not any(self.queues.values())

    def feeding(self, monkeypatch, *modules):
        fed = self

        class Random:
            def __getattr__(self, name):
                return getattr(jax.random, name)

            def randint(self, key, shape, minval, maxval, dtype=jnp.int32):
                v = fed._next('randint', shape)
                assert ((v >= minval) & (v < maxval)).all()
                return jnp.asarray(v, dtype)

            def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
                u = fed._next('uniform', shape)
                return jnp.asarray(np.float32(minval) + np.float32(maxval - minval) * u, dtype)

            def normal(self, key, shape=(), dtype=jnp.float32):
                return jnp.asarray(fed._next('normal', shape), dtype)

        class Jax:
            random = Random()

            def __getattr__(self, name):
                return getattr(jax, name)

        for module in modules:
            monkeypatch.setattr(module, 'jax', Jax())


if __name__ == '__main__':
    from superconductor_vae_tpu.checkpoint import load_checkpoint
    export_params_npz(load_checkpoint(sys.argv[1])[0], sys.argv[2])
