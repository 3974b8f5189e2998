"""Speculative decoding: an n-gram backoff draft verified by a chunked
cached forward (port of generation/speculative.py).

Greedy speculative decoding, each row advancing by its own count:
  1. draft k tokens per row by chaining the trigram table with bigram
     backoff (models/draft.py);
  2. one chunk forward (``FormulaDecoder.decode_chunk_perrow``) verifies
     all k against the model's argmax;
  3. accept the longest agreeing prefix and the model's own next token;
  4. every row advances by its own count: per-row cache writes (a dense
     gather and select) and per-row writes into a padded output buffer.

The loop is a Python loop over caches updated in place, without
gradient; it reads one flag from the device per iteration, and stops once
every row has emitted EOS or filled its buffer.  With acceptance a the
expected number of iterations is about steps / (1 + a k) instead of the
plain scan's steps.  The path is pure greedy: no stop boost, hard stop or
type mask.  The chunk forward's attention is plain PyTorch
(``mha_attention``), on caches in the [L, B, T + k + 1, H, Dh] layout, so
the decoder must be built with ``pallas_decode=False``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.layers import cast_weights_once
from ..tokenizer import BOS_ID, EOS_ID
from .generate import sequence_mask


def _as_draft_tables(draft, device) -> Dict[str, Optional[torch.Tensor]]:
    """A bare bigram [V] table or a {'bigram', 'trigram'} dict (numpy
    arrays or tensors) as tensors on ``device``: the bigram as int64 ids,
    the trigram ([V, V], -1 for unseen pairs) in its own dtype, or None."""
    def dev(a):
        return torch.as_tensor(a, device=device)
    if isinstance(draft, dict):
        trigram = draft.get('trigram')
        return {'bigram': dev(draft['bigram']).long(),
                'trigram': None if trigram is None else dev(trigram)}
    return {'bigram': dev(draft).long(), 'trigram': None}


@torch.no_grad()
def speculative_generate(decoder, z: torch.Tensor, stoich: torch.Tensor,
                         heads_vec: torch.Tensor, draft_table,
                         max_len: Optional[int] = None,
                         k: int = 4) -> Dict[str, object]:
    """Greedy speculative decode.  Returns ``tokens`` [B, max_len - 1],
    ``mask`` (up to each row's first EOS), ``acceptance_rate`` (accepted
    over drafted tokens of live rows, a float32 scalar tensor) and
    ``n_iterations`` (chunk forwards run), as the JAX function does, and
    ``margin`` [B, max_len - 1]: the gap between the two largest logits at
    the step that emitted each token (how near it came to a tie)."""
    cfg = decoder.cfg
    max_len = max_len or cfg.max_len
    steps = max_len - 1
    b = z.shape[0]
    dev = z.device
    chunk = k + 1
    tables = _as_draft_tables(draft_table, dev)
    bigram, trigram = tables['bigram'], tables['trigram']

    def draft_k(prev, cur):
        drafts = []
        for _ in range(k):
            nxt = bigram[cur]
            if trigram is not None:
                t = trigram[prev, cur].long()
                nxt = torch.where(t < 0, nxt, t)
            drafts.append(nxt)
            prev, cur = cur, nxt
        return torch.stack(drafts, dim=1)                       # [B, k]

    with cast_weights_once(decoder):
        memory = decoder.build_memory(z, stoich, heads_vec)
        mem_kvs = decoder.memory_kv(memory)
        # cache slack so that a chunk at the last position never clips
        kc, vc = decoder.init_cache(b, chunk)

        # output buffers padded so that chunk writes never clip
        out = torch.zeros(b, steps + chunk, dtype=torch.long, device=dev)
        margins = torch.zeros(b, steps + chunk, device=dev)
        opos = torch.arange(steps + chunk, device=dev)
        cpos = torch.arange(chunk, device=dev)
        rows = torch.arange(b, device=dev)
        prev = torch.full((b,), BOS_ID, dtype=torch.long, device=dev)
        cur = prev.clone()
        pos = torch.zeros(b, dtype=torch.long, device=dev)
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        acc_n = torch.zeros((), dtype=torch.long, device=dev)
        draft_n = torch.zeros((), dtype=torch.long, device=dev)
        it = 0
        while it < steps and bool((~finished & (pos < steps)).any()):
            live = ~(finished | (pos >= steps))

            # 1. chain-draft k tokens a row (trigram with bigram backoff)
            drafts = draft_k(prev, cur)
            chunk_in = torch.cat([cur[:, None], drafts], dim=1)   # [B, k+1]

            # 2. verify with one cached chunk forward at per-row positions
            safe_pos = pos.clamp(max=steps - 1)
            heads, _, _ = decoder.decode_chunk_perrow(chunk_in, safe_pos, kc, vc, mem_kvs)
            logits = heads['logits']
            model_next = logits.argmax(dim=-1)                     # [B, k+1]
            top2 = logits.float().topk(2, dim=-1).values
            gap = top2[..., 0] - top2[..., 1]

            # 3. the longest agreeing draft prefix and the model's own token
            prefix_ok = torch.cumprod((drafts == model_next[:, :k]).long(), dim=1)
            n_acc = prefix_ok.sum(dim=1)                           # [B] 0..k
            drafts_p = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
            emitted = torch.where(cpos[None, :] < n_acc[:, None], drafts_p, 0)
            emitted[rows, n_acc] = model_next.gather(1, n_acc[:, None])[:, 0]
            n_emit = n_acc + 1                                     # [B] 1..k+1
            valid = cpos[None, :] < n_emit[:, None]
            emitted = torch.where(live[:, None], emitted * valid, 0)

            # 4. each row advances by its own count; all it emitted is kept
            adv = torch.where(live, n_emit, 0)
            uidx = (opos[None, :] - safe_pos[:, None]).clamp(0, chunk - 1)
            inr = ((opos[None, :] >= safe_pos[:, None])
                   & (opos[None, :] < safe_pos[:, None] + chunk) & live[:, None])
            out = torch.where(inr, emitted.gather(1, uidx), out)
            margins = torch.where(inr, gap.gather(1, uidx), margins)
            hit_end = ((emitted == EOS_ID) & valid).any(dim=1)

            # the next (prev, cur): the last two tokens of the kept stream
            cat = torch.cat([prev[:, None], cur[:, None], emitted], dim=1)
            cur = cat.gather(1, (adv + 1)[:, None])[:, 0]
            prev = cat.gather(1, adv[:, None])[:, 0]

            acc_n += torch.where(live, n_acc, 0).sum()
            draft_n += live.sum() * k
            pos = pos + adv
            finished = finished | hit_end
            it += 1

    tokens = out[:, :steps]
    return {
        'tokens': tokens,
        'mask': sequence_mask(tokens),
        'acceptance_rate': acc_n.float() / draft_n.clamp(min=1).float(),
        'n_iterations': it,
        'margin': margins[:, :steps],
    }
