"""Policy-gradient losses: SCST and batched RLOO (port of ops/rl.py).

- The rollouts run under ``no_grad`` on the same parameters: they only
  produce sampled tokens, masks, entropies and rewards.  The REINFORCE
  log-probs come from ONE parallel teacher-forced pass over the sampled
  tokens (``rescore_log_probs``), which carries the gradient.  The
  gradient is the same (same policy, same sampled actions), and its
  backward is a TF-shaped program instead of one through 29 decode steps.
- SCST fuses its greedy baseline and its sampled rollout into one [2B]
  rollout (``greedy_mask``) over a memory built once.
- RLOO tiles the batch K times into one [B*K] rollout with leave-one-out
  baselines.
- The re-score runs under ``torch.utils.checkpoint`` (JAX:
  ``jax.checkpoint`` around it in ``scst_loss`` and ``rloo_loss``): the
  step keeps its inputs, not its activations, and recomputes it in the
  backward pass.  It runs without dropout, so the recompute is the same
  pass.
- The rollouts and the re-score run in the decoder's compute dtype; the
  log-probs are float32.
- Rewards are the V14 reward (ops/reward.py), the constraint rewards
  (ops/constraints.py) and, at ``novelty_weight > 0``, the batch novelty
  bonus.
- Under data parallelism (parallel/global_batch.py) every rank runs the
  rollouts and the rewards on the GLOBAL batch (gathered, without
  gradient), from the same generator, and keeps its own rows: the samples
  and the batch-relative novelty bonus are then the one-process run's.
  The re-score, which carries the gradient, runs on this rank's rows, and
  the loss and its metrics are this rank's shares.

``_rollout`` is looked up at call time, so a caller can replace it (the
tests and chip_smoke.py feed a fixed rollout through it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..generation.generate import GenerationConfig, generate_with_kv_cache
from ..tokenizer import BOS_ID, ELEMENT_TOKEN_START, EOS_ID, INTEGER_TOKEN_START
from ..parallel.global_batch import gather_rows, global_mean, local_rows, share
from .constraints import ConstraintConfig, constraint_rewards
from .reward import RewardConfig, batch_novelty_bonus, compute_reward


@dataclasses.dataclass(frozen=True)
class RLConfig:
    method: str = 'scst'              # 'scst' | 'rloo'
    n_samples_rloo: int = 4
    temperature: float = 1.2
    entropy_weight: float = 0.2
    max_len: int = 30
    stop_boost: float = 10.0
    hard_stop_threshold: float = 0.8
    site_dup_threshold: float = 0.0
    use_type_masking: bool = True
    reward: RewardConfig = RewardConfig()
    constraints: ConstraintConfig = ConstraintConfig()
    use_constraint_rewards: bool = True
    # batch-Jaccard novelty bonus (0 = off)
    novelty_weight: float = 0.0
    novelty_k: int = 5
    # rollouts are gradient-free, so sampling may stop once every row has
    early_exit: bool = True


def _pad_to(x: torch.Tensor, t: int, value) -> torch.Tensor:
    """``x`` [B, cur] cut or padded with ``value`` to [B, t]."""
    cur = x.shape[1]
    if cur >= t:
        return x[:, :t]
    return F.pad(x, (0, t - cur), value=value)


def _total_reward(sampled, targets, mask, cfg: RLConfig, luts,
                  family_predictions) -> torch.Tensor:
    """[B] reward + constraint rewards (+ novelty bonus), no gradient."""
    with torch.no_grad():
        r = compute_reward(sampled, targets, mask, cfg.reward,
                           fraction_values=luts['fraction_values'])
        if cfg.use_constraint_rewards:
            r = r + constraint_rewards(
                sampled, mask, luts['token_to_z'], luts['token_value_table'],
                cfg.constraints, family_predictions=family_predictions)
        if cfg.novelty_weight > 0:
            r = r + batch_novelty_bonus(
                sampled, mask, int(luts['token_value_table'].shape[0]),
                k_nearest=cfg.novelty_k, weight=cfg.novelty_weight)
    return r


def _gen_cfg(cfg: RLConfig, greedy: bool) -> GenerationConfig:
    return GenerationConfig(
        max_len=cfg.max_len,
        temperature=0.0 if greedy else cfg.temperature,
        stop_boost=cfg.stop_boost,
        hard_stop_threshold=cfg.hard_stop_threshold,
        site_dup_threshold=cfg.site_dup_threshold,
        use_type_masking=cfg.use_type_masking,
        early_exit=cfg.early_exit,
    )


def _rollout(decoder, z, stoich, heads_vec, generator, cfg: RLConfig, luts,
             greedy: bool, temperature=None, memory=None, greedy_mask=None
             ) -> Dict[str, torch.Tensor]:
    """One gated KV-cache rollout (no gradient): tokens, log_probs,
    entropy and mask, each [B, max_len - 1]."""
    return generate_with_kv_cache(
        decoder, z, stoich, heads_vec, generator, _gen_cfg(cfg, greedy),
        type_masks=luts['type_masks'] if cfg.use_type_masking else None,
        temperature=None if greedy else temperature, memory=memory,
        greedy_mask=greedy_mask)


def rescore_log_probs(
    decoder,
    z: torch.Tensor, stoich: torch.Tensor, heads_vec: torch.Tensor,
    tokens: torch.Tensor,             # [B, T] sampled rollout (no BOS)
    cfg: RLConfig,
    luts: Dict[str, torch.Tensor],
    temperature: Optional[float] = None,
) -> torch.Tensor:
    """log pi(sampled token) at each position, [B, T], by ONE parallel TF
    pass, differentiable w.r.t. the decoder's parameters, ``z``, ``stoich``
    and ``heads_vec``.

    Rebuilds the rollout's sampling distribution at each step (type
    masking, site-dup gating, stop and length boost, hard stop, degenerate
    guard, temperature) from the token stream: the decoder is causal, so
    the TF hidden state at position t is the rollout's at step t, and the
    gates' state (finished, elements seen) is a function of the tokens
    already emitted.  The pass runs without dropout whatever the decoder's
    mode, as the rollout does."""
    b, t = tokens.shape
    gcfg = _gen_cfg(cfg, greedy=False)
    if gcfg.top_k or gcfg.top_p < 1.0:
        raise NotImplementedError('rescore supports the RL gate stack only '
                                  '(no top-k/top-p)')
    tokens = tokens.long()
    inputs = torch.cat([torch.full((b, 1), BOS_ID, dtype=torch.long,
                                   device=tokens.device), tokens], dim=1)  # [B, T+1]
    was_training = decoder.training
    decoder.eval()
    try:
        # forward() reads inputs[:, :-1]: logits at t follow tokens[:, :t]
        heads = decoder(z, inputs, stoich, heads_vec)
    finally:
        decoder.train(was_training)
    logits = heads['logits'].float()                                # [B, T, V]
    neg_inf = torch.finfo(logits.dtype).min
    pos = torch.arange(t, device=tokens.device)

    # finished[t]: EOS emitted strictly before step t
    eos_cum = (tokens == EOS_ID).int().cumsum(dim=1)
    finished = torch.cat([torch.zeros(b, 1, dtype=torch.bool, device=tokens.device),
                          eos_cum[:, :-1] > 0], dim=1)              # [B, T]

    if gcfg.use_type_masking and luts.get('type_masks') is not None:
        valid = luts['type_masks'][heads['type_logits'].float().argmax(dim=-1)]
        logits = logits.masked_fill(~valid, neg_inf)

    if gcfg.site_dup_threshold > 0:
        # seen[t]: element tokens emitted before step t while unfinished
        is_elem = ((tokens >= ELEMENT_TOKEN_START) & (tokens < INTEGER_TOKEN_START)
                   & ~finished)
        onehot = F.one_hot(tokens, logits.shape[-1]) * is_elem[..., None]
        seen = (onehot.cumsum(dim=1) - onehot) > 0                  # strictly before t
        dup_prob = torch.sigmoid(heads['site_dup_logits'].float())
        suppress = (dup_prob < gcfg.site_dup_threshold) & (pos[None, :] > 0)
        logits = logits.masked_fill(suppress[..., None] & seen, -30.0)

    if gcfg.stop_boost > 0:
        stop_prob = torch.sigmoid(heads['stop_logits'].float())    # [B, T]
        length_boost = torch.where(
            pos > gcfg.length_boost_start,
            gcfg.length_boost_scale * (pos - gcfg.length_boost_start)
            / max(gcfg.max_len - gcfg.length_boost_start, 1),
            0.0).to(logits.dtype)                                   # [T]
        eos_col = logits[:, :, EOS_ID] + gcfg.stop_boost * stop_prob + length_boost
        logits = torch.cat([logits[:, :, :EOS_ID], eos_col[..., None],
                            logits[:, :, EOS_ID + 1:]], dim=-1)
        if gcfg.hard_stop_threshold > 0:
            force = (stop_prob > gcfg.hard_stop_threshold) & ~finished
            forced = torch.full((logits.shape[-1],), neg_inf, device=logits.device)
            forced[EOS_ID:EOS_ID + 1].fill_(100.0)
            logits = torch.where(force[..., None], forced, logits)

    degenerate = ~torch.isfinite(logits).any(dim=-1) | torch.isnan(logits).any(dim=-1)
    safe = logits.masked_fill(degenerate[..., None], 0.0)
    temp = gcfg.temperature if temperature is None else temperature
    # the rollout's clipped-softmax log-prob
    probs = torch.softmax(safe / temp, dim=-1).clamp_min(1e-8)
    return probs.log().gather(-1, tokens[..., None])[..., 0]


def _rescore_remat(decoder, z, stoich, heads_vec, tokens, cfg: RLConfig, luts,
                   temperature=None) -> torch.Tensor:
    """``rescore_log_probs`` under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward pass instead of held."""
    return checkpoint(
        lambda zz, st, hv: rescore_log_probs(decoder, zz, st, hv, tokens, cfg, luts,
                                             temperature=temperature),
        z, stoich, heads_vec, use_reentrant=False)


def _seq_entropy(ent, mask, position_entropy_w):
    """Masked mean entropy of each sequence, [B], optionally weighted by
    position."""
    ent_w = ent * mask
    if position_entropy_w is not None:
        ent_w = ent_w * position_entropy_w[None, :ent.shape[1]]
    return ent_w.sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)


def scst_loss(
    decoder,
    z: torch.Tensor, stoich: torch.Tensor, heads_vec: torch.Tensor,
    targets: torch.Tensor,            # [B, T] (tokens[:, 1:])
    generator: torch.Generator,
    cfg: RLConfig,
    luts: Dict[str, torch.Tensor],
    family_predictions: Optional[torch.Tensor] = None,
    sc_weight: Optional[torch.Tensor] = None,   # [B] 1 for SC rows else 0
    temperature: Optional[float] = None,
    position_entropy_w: Optional[torch.Tensor] = None,  # [T] per-position weights
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Self-critical sequence training: the greedy rollout is the
    baseline of the sampled one.  Returns (loss, mean reward, entropy,
    {'reward_var'})."""
    t = targets.shape[1]
    two = lambda x: torch.cat([x, x], dim=0)
    with torch.no_grad():
        zg, sg, hg = gather_rows(z), gather_rows(stoich), gather_rows(heads_vec)
        bg = zg.shape[0]
        memory = decoder.build_memory(zg, sg, hg)
        gmask = torch.cat([torch.ones(bg, dtype=torch.bool, device=z.device),
                           torch.zeros(bg, dtype=torch.bool, device=z.device)])
        both = _rollout(decoder, two(zg), two(sg), two(hg), generator,
                        cfg, luts, greedy=False, temperature=temperature,
                        memory=two(memory), greedy_mask=gmask)
    tokens2 = _pad_to(both['tokens'], t, 0)
    mask2 = _pad_to(both['mask'], t, 0.0)
    tg = gather_rows(targets)
    fam = gather_rows(family_predictions) if family_predictions is not None else None
    # rewards per half: the novelty bonus is batch-relative, so the greedy
    # twins must not count as neighbours of the sampled rows
    g_reward = _total_reward(tokens2[:bg], tg, mask2[:bg], cfg, luts, fam)
    s_reward = _total_reward(tokens2[bg:], tg, mask2[bg:], cfg, luts, fam)
    s_tokens, s_mask = local_rows(tokens2[bg:]), local_rows(mask2[bg:])
    s_ent = local_rows(_pad_to(both['entropy'], t, 0.0)[bg:])

    s_logp = _rescore_remat(decoder, z, stoich, heads_vec, s_tokens, cfg, luts,
                            temperature=temperature)
    adv = local_rows(s_reward - g_reward)
    per_sample = -(adv * (s_logp * s_mask).sum(dim=1))
    if sc_weight is not None:
        per_sample = per_sample * sc_weight
    seq_ent = _seq_entropy(s_ent, s_mask, position_entropy_w)
    extras = {'reward_var': share(s_reward.var(unbiased=False))}
    return global_mean(per_sample), share(s_reward.mean()), global_mean(seq_ent), extras


def rloo_loss(
    decoder,
    z: torch.Tensor, stoich: torch.Tensor, heads_vec: torch.Tensor,
    targets: torch.Tensor,
    generator: torch.Generator,
    cfg: RLConfig,
    luts: Dict[str, torch.Tensor],
    family_predictions: Optional[torch.Tensor] = None,
    sc_weight: Optional[torch.Tensor] = None,
    temperature: Optional[float] = None,
    entropy_weight: Optional[float] = None,
    position_entropy_w: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """RLOO with K leave-one-out baselines, one rollout of [B*K] rows
    (sample k of row i at k * B + i)."""
    b, t = targets.shape
    k = cfg.n_samples_rloo
    z_k, stoich_k, heads_k = (x.repeat(k, 1) for x in (z, stoich, heads_vec))
    fam = gather_rows(family_predictions) if family_predictions is not None else None
    fam_k = fam.repeat(k, 1) if fam is not None else None

    with torch.no_grad():
        zg_k, sg_k, hg_k = (gather_rows(x).repeat(k, 1) for x in (z, stoich, heads_vec))
        bg = zg_k.shape[0] // k
        sample = _rollout(decoder, zg_k, sg_k, hg_k, generator, cfg, luts,
                          greedy=False, temperature=temperature)
    s_tokens = _pad_to(sample['tokens'], t, 0)
    s_mask = _pad_to(sample['mask'], t, 0.0)
    s_ent = _pad_to(sample['entropy'], t, 0.0)
    task_r = _total_reward(s_tokens, gather_rows(targets).repeat(k, 1), s_mask, cfg,
                           luts, fam_k)
    seq_ent = _seq_entropy(s_ent, s_mask, position_entropy_w)
    ent_w = cfg.entropy_weight if entropy_weight is None else entropy_weight
    r = (task_r + ent_w * seq_ent).reshape(k, bg)
    baseline = (r.sum(dim=0, keepdim=True) - r) / max(k - 1, 1)
    adv = local_rows((r - baseline).T).T                            # [K, B]
    if bg != b:
        # this rank's rows of each sample block
        s_tokens, s_mask = (local_rows(x.reshape(k, bg, t).transpose(0, 1))
                            .transpose(0, 1).reshape(k * b, t) for x in (s_tokens, s_mask))
    s_logp = _rescore_remat(decoder, z_k, stoich_k, heads_k, s_tokens, cfg, luts,
                            temperature=temperature)
    lp = (s_logp * s_mask).sum(dim=1).reshape(k, b)
    per_sample = -(adv * lp)                                        # [K, B]
    if sc_weight is not None:
        per_sample = per_sample * sc_weight[None, :]
    # each sample contributes its own gradient: the sum over K of per-K means
    extras = {'reward_var': share(task_r.var(unbiased=False))}
    return share(per_sample.mean(dim=1).sum()), share(r.mean()), share(seq_ent.mean()), extras
