"""Batched autoregressive generation with a fixed-shape KV cache (port of
generation/generate.py).

The reference's per-step gating stack (token-type hard masking,
site-duplication gating, stop-head boost, hard-stop forcing,
length-conditional boost, NaN/Inf guards, temperature / top-k / top-p)
runs as whole-batch tensor ops.  The step loop is a Python loop over the
decoder's cached ``decode_step``; with ``early_exit`` it stops once every
row has emitted EOS, which reads one flag from the device per step.
Sampling draws from an explicit ``torch.Generator``.

The decoder runs in its compute dtype, with its weights cast once for the
whole rollout (``cast_weights_once``); the gated logits are float32, and
the stop, type and site-dup heads are read in the compute dtype, as in the
JAX loop.

A tensor-parallel decoder (``decoder.tp``) has the whole logits on every
rank of its model group, so every rank takes the same tokens (a sampling
rollout draws from a generator seeded alike on every rank).  The rollout
holds it to that: the early-exit flag is taken over the group (every rank
stops at the same step) and the streams are compared across the group at
the end, raising on every rank if they differ.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..models.layers import cast_weights_once
from ..parallel.tensor import all_across, check_equal_across
from ..tokenizer import BOS_ID, EOS_ID, ELEMENT_TOKEN_START, INTEGER_TOKEN_START


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Generation knobs."""
    max_len: int = 30
    temperature: float = 1.0
    top_k: int = 0                   # 0 = disabled
    top_p: float = 1.0               # 1.0 = disabled
    stop_boost: float = 0.0
    hard_stop_threshold: float = 0.0
    site_dup_threshold: float = 0.0
    use_type_masking: bool = False
    length_boost_start: int = 10
    length_boost_scale: float = 10.0
    # stop once every row has emitted EOS; token-identical to the fixed
    # loop up to each row's first EOS (later positions stay 0)
    early_exit: bool = False

    @property
    def greedy(self) -> bool:
        return self.temperature < 0.01


def _apply_gates(logits, heads, pos: int, finished, seen_elements,
                 type_masks, gcfg: GenerationConfig):
    """The reference's per-step gating stack as whole-batch tensor ops."""
    neg_inf = torch.finfo(logits.dtype).min

    # hard type masking: predicted type -> only tokens of that type
    if gcfg.use_type_masking and type_masks is not None:
        valid = type_masks[heads['type_logits'].argmax(dim=-1)]   # [B, V]
        logits = logits.masked_fill(~valid, neg_inf)

    # site-duplication gating: soft-suppress (-30) already-seen elements
    # unless the dup head clears the threshold (V13 element range)
    if gcfg.site_dup_threshold > 0 and pos > 0:
        suppress = torch.sigmoid(heads['site_dup_logits']) < gcfg.site_dup_threshold
        logits = logits.masked_fill(suppress[:, None] & seen_elements, -30.0)

    # stop machinery: EOS boost from the stop head plus a length ramp
    if gcfg.stop_boost > 0:
        stop_prob = torch.sigmoid(heads['stop_logits'])            # [B]
        length_boost = 0.0
        if pos > gcfg.length_boost_start:
            length_boost = (gcfg.length_boost_scale
                            * (pos - gcfg.length_boost_start)
                            / max(gcfg.max_len - gcfg.length_boost_start, 1))
        logits = logits.clone()
        # the boost in the head's dtype, added to the ramp in the logits'
        logits[:, EOS_ID] += (gcfg.stop_boost * stop_prob).to(logits.dtype) + length_boost

        if gcfg.hard_stop_threshold > 0:
            force = (stop_prob > gcfg.hard_stop_threshold) & ~finished
            forced = torch.full_like(logits, neg_inf)
            forced[:, EOS_ID] = 100.0
            logits = torch.where(force[:, None], forced, logits)

    return logits


def _filter_top_k_top_p(logits, gcfg: GenerationConfig):
    neg_inf = torch.finfo(logits.dtype).min
    if gcfg.top_k and gcfg.top_k > 0:
        kth = logits.topk(gcfg.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, neg_inf)
    if gcfg.top_p < 1.0:
        sorted_logits = logits.sort(dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        # keep tokens whose prefix-exclusive cumulative prob < top_p
        # (always keep the top-1)
        cutoff = probs.cumsum(dim=-1) - probs >= gcfg.top_p
        cutoff[:, 0] = False
        min_kept = sorted_logits.masked_fill(cutoff, float('inf')).min(
            dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < min_kept, neg_inf)
    return logits


@torch.no_grad()
def generate_with_kv_cache(
    decoder,                  # FormulaDecoder, in eval mode
    z: torch.Tensor,
    stoich: torch.Tensor,
    heads_vec: torch.Tensor,
    generator: Optional[torch.Generator],
    gcfg: GenerationConfig,
    type_masks: Optional[torch.Tensor] = None,   # [5, V] bool
    memory: Optional[torch.Tensor] = None,
    temperature: Optional[float] = None,
    greedy_mask: Optional[torch.Tensor] = None,  # [B] bool: per-row argmax
) -> Dict[str, torch.Tensor]:
    """Batched AR rollout.  Returns tokens / log_probs / entropy / mask,
    each [B, max_len - 1] (the stream excludes the BOS input).  A greedy
    rollout also returns ``margin``: the gap between the two largest gated
    logits at each step, which says how near a step was to a tie.

    ``generator`` draws the samples of a sampling rollout (it may be None
    for a greedy one); ``greedy_mask`` takes the argmax for the rows it
    marks.  Forward only: the caches are updated in place, and the
    decoder's weights are cast to its compute dtype once for the rollout."""
    if not gcfg.greedy and generator is None:
        raise ValueError('a sampling rollout needs a torch.Generator')
    b = z.shape[0]
    dev = z.device
    vocab = decoder.cfg.vocab_size
    steps = gcfg.max_len - 1
    tp = getattr(decoder, 'tp', None)

    with cast_weights_once(decoder):
        if memory is None:
            memory = decoder.build_memory(z, stoich, heads_vec)
        mem_kvs = decoder.memory_kv(memory)
        kc, vc = decoder.init_cache(b)

        tok = torch.full((b,), BOS_ID, dtype=torch.long, device=dev)
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        seen = torch.zeros(b, vocab, dtype=torch.bool, device=dev)
        rows = torch.arange(b, device=dev)
        tokens = torch.zeros(b, steps, dtype=torch.long, device=dev)
        log_probs = torch.zeros(b, steps, device=dev)
        entropies = torch.zeros(b, steps, device=dev)
        margins = torch.zeros(b, steps, device=dev)

        for pos in range(steps):
            if gcfg.early_exit and (bool(finished.all()) if tp is None
                                    else all_across(finished.all(), tp)):
                break
            heads, kc, vc = decoder.decode_step(tok, pos, kc, vc, mem_kvs)
            logits = _apply_gates(heads['logits'].float(), heads, pos, finished,
                                  seen, type_masks, gcfg)

            # NaN/Inf guard: degenerate rows fall back to uniform
            degenerate = ~torch.isfinite(logits).any(dim=-1) | torch.isnan(logits).any(dim=-1)
            safe_logits = logits.masked_fill(degenerate[:, None], 0.0)

            # entropy BEFORE temperature / filtering
            probs_ent = torch.softmax(safe_logits, dim=-1).clamp_min(1e-8)
            entropy = -(probs_ent * probs_ent.log()).sum(dim=-1)
            entropy = entropy.masked_fill(degenerate, math.log(vocab))

            if gcfg.greedy:
                top2 = safe_logits.topk(2, dim=-1).values
                margins[:, pos] = top2[:, 0] - top2[:, 1]
                next_tok = safe_logits.argmax(dim=-1)
                log_prob = torch.zeros(b, device=dev)
            else:
                temp = gcfg.temperature if temperature is None else temperature
                t_logits = _filter_top_k_top_p(safe_logits / temp, gcfg)
                t_logits = t_logits.masked_fill(degenerate[:, None], 0.0)
                probs = torch.softmax(t_logits, dim=-1)
                next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
                log_prob = probs.clamp_min(1e-8).log()[rows, next_tok]
                if greedy_mask is not None:
                    next_tok = torch.where(greedy_mask, safe_logits.argmax(dim=-1), next_tok)
                    log_prob = log_prob.masked_fill(greedy_mask, 0.0)

            # track seen element tokens
            is_elem = ((next_tok >= ELEMENT_TOKEN_START)
                       & (next_tok < INTEGER_TOKEN_START) & ~finished)
            seen[rows, next_tok] |= is_elem

            finished = finished | (next_tok == EOS_ID)
            tokens[:, pos] = next_tok
            log_probs[:, pos] = log_prob
            entropies[:, pos] = entropy
            tok = next_tok

    if tp is not None:
        check_equal_across(tokens, tp, 'the rollout\'s tokens')
    out = {'tokens': tokens, 'log_probs': log_probs, 'entropy': entropies,
           'mask': sequence_mask(tokens)}
    if gcfg.greedy:
        out['margin'] = margins
    return out


def sequence_mask(tokens: torch.Tensor) -> torch.Tensor:
    """1.0 for positions up to and including the first EOS, else 0.0."""
    seq_len = tokens.shape[1]
    is_end = tokens == EOS_ID
    end_pos = is_end.int().argmax(dim=1)
    end_pos = torch.where(is_end.any(dim=1), end_pos, seq_len)
    positions = torch.arange(seq_len, device=tokens.device)[None, :]
    return (positions <= end_pos[:, None]).float()


def sample_for_reinforce(decoder, z, stoich, heads_vec, generator, gcfg,
                         type_masks=None, memory=None):
    """RL sampling wrapper: returns (tokens, log_probs, entropy, mask)."""
    out = generate_with_kv_cache(decoder, z, stoich, heads_vec, generator,
                                 gcfg, type_masks=type_masks, memory=memory)
    return out['tokens'], out['log_probs'], out['entropy'], out['mask']
