"""The port's legacy models (models/feature_groups.py, models/legacy.py),
isotope tables (chem/isotopes.py) and vocabulary builder
(scripts/build_vocab.py) against the JAX package.

The flax modules are initialised by flax, their parameters handed to the
port through the converters of checkpoint/from_jax.py, and both run on
the same numpy inputs: outputs and the gradients with respect to the
inputs within 1e-5, and each parameter's gradient within 1e-5 of its
largest component (at least 1; the contrastive loss divides by a
temperature of 0.07, which scales its gradients to about 10), float32 on
both sides.  The JAX functions run under ``jax.jit``.  Sampling
cannot match across frameworks, so the VAE runs with ``sample=False`` and
with JAX's own normal draw fed to the port as ``noise``.  The isotope
tables are bit-equal, and ``build_vocab``'s two JSON files byte-equal to
the JAX script's on the same CSV.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import superconductor_vae_tpu.chem.isotopes as jiso
from superconductor_vae_tpu.models import feature_groups as jfg
from superconductor_vae_tpu.models import legacy as jlegacy
from superconductor_vae_tpu_torch.checkpoint import from_jax
from superconductor_vae_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from superconductor_vae_tpu_torch.chem import isotopes
from superconductor_vae_tpu_torch.scripts import build_vocab
import torch_port_threads  # noqa: F401  (one torch thread a process)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-5                   # of the largest component (at least 1)
B = 4


def _np_tree(params):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), params)


def _close(got, want, what=''):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=what, **TOL)


def _grad_state(grads, attention=None):
    """A flax gradient tree in the port's state-dict keys and layouts."""
    g = _np_tree(grads)['params']
    if attention:
        g = dict(g)
        g[attention] = from_jax._flatten_attention(g[attention])
    return state_dict_from_flax(g)


def _check_param_grads(module, jax_grads, attention=None):
    """Each parameter's gradient (zero where none reached it) against
    JAX's, within GRAD_REL of the gradient's largest component."""
    want = _grad_state(jax_grads, attention)
    params = dict(module.named_parameters())
    # parameters the flax tree lacks (a group absent from the call) get none
    assert set(want) <= set(params)
    assert all(params[k].grad is None for k in set(params) - set(want))
    got = {k: torch.zeros_like(params[k]) if params[k].grad is None else params[k].grad
           for k in want}
    for k in want:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=GRAD_REL * max(float(np.abs(w).max()), 1.0), err_msg=k)


def _groups(dims, seed=0):
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal((B, d)).astype(np.float32) for name, d in dims.items()}


# -- feature groups ----------------------------------------------------------------

@pytest.mark.parametrize('absent', [None, 'structure'])
def test_grouped_feature_encoder(absent):
    dims = dict(jfg.DEFAULT_GROUP_DIMS, structure=12)
    g = _groups(dims)
    if absent:
        g[absent] = None
    jmod = jfg.GroupedFeatureEncoder(dims, hidden_dim=16, n_heads=4)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), {k: None if v is None else jnp.asarray(v)
                                                        for k, v in g.items()})
    port = from_jax.grouped_feature_encoder_from_jax(_np_tree(params), dims, 16, 4,
                                                     device='cpu')
    assert (f'enc_{absent}' in dict(port.named_children())) if absent else True

    def jloss(p, gi):
        out, attn = jmod.apply(p, gi, return_attention=True)
        return (out ** 2).sum() + (attn * jnp.arange(attn.shape[-1])).sum(), (out, attn)

    jg = {k: jnp.asarray(v) for k, v in g.items() if v is not None}
    (_, (jout, jattn)), (pgrad, igrad) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jg)
    tg = {k: None if v is None else torch.tensor(v, requires_grad=True) for k, v in g.items()}
    out, attn = port(tg, return_attention=True)
    _close(out, jout, 'out')
    _close(attn, jattn, 'attention')
    _close(port(tg), jax.jit(jmod.apply)(params, jg), 'out without the attention map')
    ((out ** 2).sum() + (attn * torch.arange(attn.shape[-1])).sum()).backward()
    for k, v in igrad.items():
        _close(tg[k].grad, v, f'd/d{k}')
    _check_param_grads(port, pgrad, attention='cross_attention')


def test_expert_heads():
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((B, 3, 16)).astype(np.float32)
    for jcls, conv, kw in ((jfg.ExpertAttentionHead, from_jax.expert_attention_head_from_jax,
                            dict(temperature=0.5)),
                           (jfg.AttentiveExpert, from_jax.attentive_expert_from_jax,
                            dict(output_dim=2, temperature=0.5))):
        jmod = jcls(16, **kw)
        params = jax.jit(jmod.init)(jax.random.PRNGKey(2), jnp.asarray(emb))

        def jloss(p, x):
            out = jmod.apply(p, x)
            out = out if isinstance(out, tuple) else (out,)
            return sum((o * jnp.cos(jnp.arange(o.size).reshape(o.shape))).sum() for o in out), out

        (_, jout), (pgrad, xgrad) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(emb))
        port = conv(_np_tree(params), 16, device='cpu', **kw)
        x = torch.tensor(emb, requires_grad=True)
        out = port(x)
        out = out if isinstance(out, tuple) else (out,)
        for o, w in zip(out, jout):
            _close(o, w, jcls.__name__)
        sum((o * torch.cos(torch.arange(o.numel()).reshape(o.shape))).sum()
            for o in out).backward()
        _close(x.grad, xgrad, f'{jcls.__name__} d/dx')
        _check_param_grads(port, pgrad)


def test_contrastive_feature_encoder_and_loss():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 20)).astype(np.float32)
    neg = rng.standard_normal((5, 20)).astype(np.float32)
    jmod = jfg.ContrastiveFeatureEncoder(20, latent_dim=8, hidden_dims=(24, 12))
    encode_project = jax.jit(lambda *a: jmod.apply(
        *a, method=jfg.ContrastiveFeatureEncoder.encode_project))
    params = jax.jit(lambda k, a: jmod.init(
        k, a, method=jfg.ContrastiveFeatureEncoder.encode_project))(jax.random.PRNGKey(0),
                                                                    jnp.asarray(x))

    def jloss(p, a, b):
        za, zb = jmod.apply(p, a), jmod.apply(p, b)
        return jmod.apply(p, za, zb, method=jfg.ContrastiveFeatureEncoder.contrastive_loss)

    jl, (pgrad, agrad) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(x), jnp.asarray(neg))
    port = from_jax.contrastive_feature_encoder_from_jax(_np_tree(params), 20, 8, (24, 12),
                                                         device='cpu')
    xa = torch.tensor(x, requires_grad=True)
    z, proj = port.encode_project(xa)
    jz, jproj = encode_project(params, jnp.asarray(x))
    _close(z, jz, 'z')
    _close(proj, jproj, 'projection')
    loss = port.contrastive_loss(port(xa), port(torch.as_tensor(neg)))
    _close(loss, jl, 'loss')
    loss.backward()
    _close(xa.grad, agrad, 'd/dx')
    _check_param_grads(port, pgrad)


# -- the legacy models ---------------------------------------------------------------

@pytest.mark.parametrize('fed_noise', [False, True])
def test_bidirectional_vae_and_loss(fed_noise):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 30)).astype(np.float32)
    tc = rng.standard_normal(B).astype(np.float32)
    jmod = jlegacy.BidirectionalVAE(feature_dim=30, hidden_dims=(24, 16), latent_dim=8)
    params = jax.jit(lambda k, a: jmod.init(k, a, sample=False))(jax.random.PRNGKey(0),
                                                                jnp.asarray(x))
    key = jax.random.PRNGKey(7) if fed_noise else None

    def jloss(p):
        out = jmod.apply(p, jnp.asarray(x), key, sample=fed_noise)
        return jlegacy.BidirectionalVAE.loss(out, jnp.asarray(x), jnp.asarray(tc))['total'], out

    (jl, jout), pgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    port = from_jax.bidirectional_vae_from_jax(_np_tree(params), 30, (24, 16), 8, device='cpu')
    noise = (torch.as_tensor(np.asarray(jax.random.normal(key, (B, 8))))
             if fed_noise else None)
    out = port(torch.as_tensor(x), sample=fed_noise, noise=noise)
    for k in ('recon', 'z', 'z_mean', 'z_logvar', 'tc_pred', 'competence'):
        _close(out[k], jout[k], k)
    losses = port.loss(out, torch.as_tensor(x), torch.as_tensor(tc))
    _close(losses['total'], jl, 'total')
    losses['total'].backward()
    _check_param_grads(port, pgrad)
    # a generator's draw: z = mean + std * eps, eps from the generator
    g = torch.Generator().manual_seed(0)
    eps = torch.randn((B, 8), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        drawn = port(torch.as_tensor(x), generator=g)
    torch.testing.assert_close(drawn['z'], drawn['z_mean'] + torch.exp(
        0.5 * drawn['z_logvar']) * eps)


def test_pointer_generator_decoder():
    rng = np.random.default_rng(5)
    vocab, s, t = 40, 5, 7
    src = rng.integers(5, vocab, (B, s)).astype(np.int32)
    mask = np.arange(s)[None, :] < rng.integers(1, s + 1, B)[:, None]
    tgt = rng.integers(0, vocab, (B, t)).astype(np.int32)
    jmod = jlegacy.PointerGeneratorDecoder(vocab, d_model=16, nhead=4, max_src=s)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(1), src, mask, tgt)

    def jloss(p):
        out = jmod.apply(p, src, mask, tgt)
        nll = -jnp.take_along_axis(out['log_probs'], tgt[..., None], axis=-1).mean()
        return nll + out['p_gen'].mean(), out

    (jl, jout), pgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    port = from_jax.pointer_generator_from_jax(_np_tree(params), vocab, 16, 4, s, device='cpu')
    out = port(torch.as_tensor(src).long(), torch.as_tensor(mask), torch.as_tensor(tgt).long())
    for k in ('log_probs', 'p_gen', 'copy_attention'):
        _close(out[k], jout[k], k)
    nll = -out['log_probs'].gather(-1, torch.as_tensor(tgt).long()[..., None]).mean()
    loss = nll + out['p_gen'].mean()
    _close(loss, jl, 'loss')
    loss.backward()
    _check_param_grads(port, pgrad)


# -- isotopes and the vocab builder --------------------------------------------------

def test_isotope_tables_bit_equal():
    assert isotopes.ISOTOPES == jiso.ISOTOPES and len(isotopes.ISOTOPES) > 200
    np.testing.assert_array_equal(isotopes.isotope_feature_matrix(),
                                  jiso.isotope_feature_matrix())
    some = ['18O', '2H', '13C', '235U', '999Og', '7Li']
    np.testing.assert_array_equal(isotopes.isotope_feature_matrix(some),
                                  jiso.isotope_feature_matrix(some))
    for iso in isotopes.ISOTOPES + some:
        assert isotopes.nuclear_spin(iso) == jiso.nuclear_spin(iso)
        assert isotopes.estimate_isotope_effect(iso) == jiso.estimate_isotope_effect(iso)
        assert isotopes.estimate_isotope_effect(iso, 0.3) == jiso.estimate_isotope_effect(iso, 0.3)
    for f in ['YBa2Cu3O7', 'La{18}O(1/2)Fe', '18OSr2CuO4', 'Mg{11}B2', 'Nb3.5Ge(1/4)',
              'Xx2O', 'H{2}2S']:
        got, want = isotopes.encode_isotope_composition(f), jiso.encode_isotope_composition(f)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f'{f} {k}')
    for bad in ('', '123'):
        with pytest.raises(ValueError):
            isotopes.encode_isotope_composition(bad)
    with pytest.raises(ValueError):
        isotopes.parse_isotope('O18x')


def test_build_vocab_byte_equal(tmp_path, monkeypatch):
    csv = tmp_path / 'small.csv'
    csv.write_text('formula,Tc\nYBa2Cu3O(13/2),92\nLa(9/5)Sr(1/5)CuO4,38\n'
                   'Nb3Sn,18\n,5\nMgB2(2/4),39\nTl2Ba2Ca(19/20)Y(1/20)Cu2O8,100\n'
                   '"La(9/5)Sr(1/5)CuO4",38\n')
    build_vocab.main(['--csv', str(csv), '--out', str(tmp_path / 'port')])
    spec = importlib.util.spec_from_file_location('jax_build_vocab',
                                                  ROOT / 'scripts' / 'build_vocab.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, 'argv', ['build_vocab.py', '--csv', str(csv), '--out',
                                      str(tmp_path / 'jax')])
    mod.main()
    for name in ('fraction_vocab.json', 'isotope_vocab.json'):
        assert (tmp_path / 'port' / name).read_bytes() == (tmp_path / 'jax' / name).read_bytes()
