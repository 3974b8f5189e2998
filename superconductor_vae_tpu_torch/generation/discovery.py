"""End-to-end discovery pipeline: analyse -> generate -> decode -> validate
-> rank (port of generation/discovery.py).

The latents of every strategy are decoded in one batched KV-cache rollout
(``generate_with_kv_cache``; through the decode-step kernel K1 when the
decoder is built with ``pallas_decode``); only the string validation and
the ranking run on the host.  Sampling draws from explicit
``torch.Generator``s, each named by an integer path (utils/rng.py) where
JAX folds a key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.pipeline import DatasetArrays
from ..models import FormulaDecoder, MaterialsEncoder
from ..models.encoder import predict_tc_mc
from ..models.layers import eval_mode
from ..postprocessing import FormulaCorrector
from ..tokenizer import FractionAwareTokenizer
from ..utils.rng import key_generator, stream_seed
from ..validation import CandidateValidator, PhysicsValidator
from .candidate_generator import CandidateGenerator
from .generate import GenerationConfig, generate_with_kv_cache
from .latent_analyzer import LatentSpaceAnalyzer
from .stoich_snap import rational_snap_stoich


@dataclasses.dataclass
class Candidate:
    formula: str
    tc_pred_kelvin: float
    sc_prob: float
    validation_score: float
    physics_plausibility: float
    novelty: bool
    strategy: str
    rank_score: float = 0.0
    tc_uncertainty: float = 0.0    # MC-dropout std, normalized Tc units


class SuperconductorDiscoveryPipeline:
    """``encoder`` and ``decoder`` hold their weights; they are used in
    eval mode and given their modes back.  ``type_masks`` ([5, V] bool, the
    tokenizer's) turns on hard type masking in the gated decodes."""

    def __init__(self, encoder: MaterialsEncoder, decoder: FormulaDecoder,
                 tokenizer: FractionAwareTokenizer, ds: DatasetArrays,
                 type_masks=None):
        self.encoder, self.decoder = encoder, decoder
        self.device = next(encoder.parameters()).device
        self.tokenizer = tokenizer
        self.ds = ds
        self.type_masks = self._masks(type_masks)
        self.analyzer = LatentSpaceAnalyzer(encoder)
        self.generator = CandidateGenerator(encoder)
        self.validator = CandidateValidator()
        self.physics = PhysicsValidator()
        self.corrector = FormulaCorrector()
        self.known = set(ds.formulas)

    def _masks(self, masks) -> Optional[torch.Tensor]:
        if masks is None:
            return None
        return torch.as_tensor(np.asarray(masks), dtype=torch.bool, device=self.device)

    def _as_z(self, z) -> torch.Tensor:
        return torch.as_tensor(z, dtype=torch.float32, device=self.device)

    def _rollout(self, z, stoich, heads_vec, gcfg, generator, tm, temperature=None):
        """Token rows [B, max_len - 1] as numpy."""
        with eval_mode(self.decoder):
            out = generate_with_kv_cache(self.decoder, z, stoich, heads_vec, generator,
                                         gcfg, type_masks=tm, temperature=temperature)
        return out['tokens'].cpu().numpy()

    def decode_latents(self, z, temperature: float = 0.0,
                       generator: Optional[torch.Generator] = None,
                       type_masks=None, chunk: Optional[int] = None,
                       pure_greedy: bool = False,
                       snap_stoich: bool = False) -> List[str]:
        """z -> formulas through the encoder's heads and a batched KV-cache
        decode.

        ``chunk``: decode in fixed-size chunks of this many latents, the
        last one padded by repeating its final row (the padded rows are
        dropped), which bounds the KV-cache footprint of large pools and
        keeps every call at one shape.  A sampled decode
        (``temperature`` >= 0.01) draws from ``generator`` (from the stream
        (0,) when None), chunk after chunk.

        ``pure_greedy``: no generation-time gates (no stop boost, hard stop
        or type masking), so the rollout is plain per-step argmax: the
        quantity decoder inversion optimises, whose teacher-forced argmax
        equals this rollout by induction.

        ``snap_stoich``: rational-snap the fraction head's predicted stoich
        conditioning before the decode (generation/stoich_snap.py).
        """
        greedy = temperature < 0.01
        gcfg = GenerationConfig(
            max_len=self.decoder.cfg.max_len,
            temperature=0.0 if greedy else 1.0,
            stop_boost=0.0 if pure_greedy else 10.0,
            hard_stop_threshold=0.0 if pure_greedy else 0.8,
            use_type_masking=self.type_masks is not None and not pure_greedy,
            early_exit=True)
        tm = self.type_masks if type_masks is None else self._masks(type_masks)
        if not gcfg.use_type_masking:
            tm = None
        if not greedy and generator is None:
            generator = key_generator((0,), self.device)
        temp = None if greedy else max(temperature, 1e-3)
        z = self._as_z(z)
        size = len(z) if chunk is None or len(z) <= chunk else chunk
        out: List[str] = []
        for i in range(0, len(z), size):
            zc = z[i:i + size]
            n = len(zc)
            if n < size:
                zc = torch.cat([zc, zc[-1:].expand(size - n, -1)])
            heads = self._full_heads(zc)
            stoich = heads['stoich']
            if snap_stoich:
                stoich = rational_snap_stoich(stoich)
            toks = self._rollout(zc, stoich, heads['heads_vec'], gcfg, generator, tm, temp)
            out.extend(self.tokenizer.decode(t) for t in toks[:n])
        return out

    def decode_conditioned(self, z, stoich, heads_vec, type_masks=None) -> List[str]:
        """Greedy decode with EXPLICIT conditioning (the AR-eval convention:
        ground-truth stoich + the encoder-head vector) instead of the
        ``heads_from_z`` predicted conditioning ``decode_latents`` uses:
        the full-supervision reconstruction diagnostic (oracle), since the
        decoder is hypersensitive to the fraction head's conditioning
        error."""
        gcfg = GenerationConfig(
            max_len=self.decoder.cfg.max_len, temperature=0.0,
            stop_boost=10.0, hard_stop_threshold=0.8,
            use_type_masking=self.type_masks is not None, early_exit=True)
        tm = self.type_masks if type_masks is None else self._masks(type_masks)
        if not gcfg.use_type_masking:
            tm = None
        toks = self._rollout(self._as_z(z), self._as_z(stoich), self._as_z(heads_vec),
                             gcfg, None, tm)
        return [self.tokenizer.decode(t) for t in toks]

    def _full_heads(self, z) -> Dict[str, torch.Tensor]:
        """Inference-mode head assembly from z (no input features)."""
        with torch.no_grad(), eval_mode(self.encoder):
            return self.encoder.heads_from_z(self._as_z(z))

    def run(self, n_candidates: int = 256, seed: int = 0,
            strategies: tuple = ('clusters', 'gradient', 'interpolation',
                                 'evolutionary')) -> List[Candidate]:
        cache = self.analyzer.build_cache(self.ds)
        clusters = self.analyzer.find_high_tc_clusters(cache)
        per = max(n_candidates // max(len(strategies), 1), 8)

        latents, labels = [], []
        if 'clusters' in strategies and clusters:
            centers = np.stack([c['center'] for c in clusters[:4]])
            z = self.generator.sample_clusters(
                centers, per // len(centers) + 1, sigma=0.5,
                generator=key_generator((seed, 1), self.device))
            latents.append(z[:per]); labels += ['clusters'] * min(per, len(z))
        top = np.argsort(-cache.tc_kelvin)[:max(per, 16)]
        z_top = self._as_z(cache.z[top])
        if 'gradient' in strategies:
            z = self.generator.gradient_ascent_tc(z_top[:per])
            latents.append(z); labels += ['gradient'] * len(z)
        if 'interpolation' in strategies and len(top) >= 2:
            half = min(per // 8 + 1, len(top) // 2)
            z = self.generator.interpolate_pairs(
                z_top[:half], z_top[half:2 * half], n=8)
            latents.append(z[:per]); labels += ['interpolation'] * min(per, len(z))
        if 'evolutionary' in strategies:
            z = self.generator.evolutionary(
                z_top[:per], key_generator((seed, 2), self.device))
            latents.append(z); labels += ['evolutionary'] * len(z)

        all_z = torch.cat(latents, dim=0)
        heads = self._full_heads(all_z)
        formulas = self.decode_latents(all_z)
        sc_prob = torch.sigmoid(heads['sc_pred'].float()).cpu().numpy()
        # MC-dropout refinement: the mean replaces the single-pass tc_pred,
        # the std flags low-confidence candidates
        tc_mc_mean, tc_mc_std = predict_tc_mc(self.encoder, all_z, stream_seed((seed, 9)))
        tc_pred = tc_mc_mean.cpu().numpy()
        tc_std = tc_mc_std.cpu().numpy()
        tc_kelvin = self.ds.norm_stats.tc_to_kelvin(tc_pred)

        out: List[Candidate] = []
        seen = set()
        for i, f in enumerate(formulas):
            f = self.corrector.correct(f).corrected
            if not f or f in seen:
                continue
            seen.add(f)
            v = self.validator.validate(f)
            if not v.is_valid:
                continue
            p = self.physics.validate(f)
            cand = Candidate(
                formula=f,
                tc_pred_kelvin=float(tc_kelvin[i]),
                sc_prob=float(sc_prob[i]),
                validation_score=v.score,
                physics_plausibility=p.plausibility,
                novelty=f not in self.known,
                strategy=labels[i] if i < len(labels) else 'unknown',
                tc_uncertainty=float(tc_std[i]))
            # high MC-dropout uncertainty discounts the rank (soft penalty:
            # 1 std in normalized units halves the score)
            cand.rank_score = (cand.sc_prob * cand.validation_score
                               * cand.physics_plausibility
                               * (1.0 + cand.tc_pred_kelvin / 100.0)
                               * (1.2 if cand.novelty else 1.0)
                               / (1.0 + cand.tc_uncertainty))
            out.append(cand)
        return sorted(out, key=lambda c: -c.rank_score)
