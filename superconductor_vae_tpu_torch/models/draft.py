"""Draft models for speculative decoding (port of models/draft.py).

The n-gram draft is two dense tables, so that drafting k tokens is k
gathers on the device:

  * ``trigram [V, V] int16``: the most frequent successor of the context
    pair (prev, cur), -1 where the pair was never observed (the signal to
    back off);
  * ``bigram [V] int32``: the most frequent successor of cur.

Both are grammar-constrained at build time by the token-type transition
FSM (``_ALLOWED``), so an illegal successor is never drafted.  They are
built once from the training token arrays with numpy and saved as .npz.
The table builders keep the JAX package's stable sorts and ``np.unique``'s
argmax tie order, so the tables are bit-equal to its.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from ..tokenizer import (
    EOS_ID, PAD_ID, TOKEN_TYPE_ELEMENT, TOKEN_TYPE_EOS, TOKEN_TYPE_FRACTION,
    TOKEN_TYPE_INTEGER, TOKEN_TYPE_SPECIAL, FractionAwareTokenizer)

# formula grammar FSM: allowed successor TYPES per type
# element -> element | integer | fraction | EOS
# integer -> element | EOS ; fraction -> element | EOS
# special(BOS/iso) -> element | integer | fraction | special ; EOS -> EOS
_ALLOWED = {
    TOKEN_TYPE_ELEMENT: (TOKEN_TYPE_ELEMENT, TOKEN_TYPE_INTEGER,
                         TOKEN_TYPE_FRACTION, TOKEN_TYPE_EOS),
    TOKEN_TYPE_INTEGER: (TOKEN_TYPE_ELEMENT, TOKEN_TYPE_EOS),
    TOKEN_TYPE_FRACTION: (TOKEN_TYPE_ELEMENT, TOKEN_TYPE_EOS),
    TOKEN_TYPE_SPECIAL: (TOKEN_TYPE_ELEMENT, TOKEN_TYPE_INTEGER,
                         TOKEN_TYPE_FRACTION, TOKEN_TYPE_SPECIAL),
    TOKEN_TYPE_EOS: (TOKEN_TYPE_EOS,),
}


def build_bigram_draft(tokens: np.ndarray, tokenizer: FractionAwareTokenizer,
                       grammar_constrained: bool = True) -> np.ndarray:
    """[N, T] token arrays -> ``[V]`` int32 next-token table: for each
    token id the most frequent (grammar-legal) successor in the corpus, EOS
    where none was observed."""
    v = tokenizer.vocab_size
    types = tokenizer.token_type_table

    cur = tokens[:, :-1].reshape(-1)
    nxt = tokens[:, 1:].reshape(-1)
    keep = (cur != PAD_ID) & (nxt != PAD_ID)
    cur, nxt = cur[keep], nxt[keep]

    table = np.full(v, EOS_ID, np.int32)
    # group by the current token; the argmax successor of each group
    order = np.argsort(cur, kind='stable')
    cur_s, nxt_s = cur[order], nxt[order]
    boundaries = np.searchsorted(cur_s, np.arange(v + 1))
    for t in np.unique(cur_s):
        succ = nxt_s[boundaries[t]:boundaries[t + 1]]
        if grammar_constrained:
            succ = succ[np.isin(types[succ], _ALLOWED[int(types[t])])]
        if len(succ):
            vals, cnts = np.unique(succ, return_counts=True)
            table[t] = vals[np.argmax(cnts)]
    return table


def build_ngram_draft(tokens: np.ndarray, tokenizer: FractionAwareTokenizer,
                      grammar_constrained: bool = True) -> Dict[str, np.ndarray]:
    """The backoff draft: ``{'bigram': [V] int32, 'trigram': [V, V] int16}``.
    The trigram table holds, for every observed (prev, cur) pair, the most
    frequent (grammar-legal) successor, and -1 for unseen pairs (about 45
    MB at V = 4,752)."""
    v = tokenizer.vocab_size
    types = tokenizer.token_type_table

    bigram = build_bigram_draft(tokens, tokenizer, grammar_constrained=grammar_constrained)

    prev = tokens[:, :-2].reshape(-1)
    cur = tokens[:, 1:-1].reshape(-1)
    nxt = tokens[:, 2:].reshape(-1)
    keep = (prev != PAD_ID) & (cur != PAD_ID) & (nxt != PAD_ID)
    prev, cur, nxt = prev[keep], cur[keep], nxt[keep]
    if grammar_constrained:
        legal = np.zeros((5, 5), bool)
        for t, allowed in _ALLOWED.items():
            legal[t, list(allowed)] = True
        ok = legal[types[cur], types[nxt]]
        prev, cur, nxt = prev[ok], cur[ok], nxt[ok]

    trigram = np.full((v, v), -1, np.int16)
    # group by the context key prev * V + cur; the argmax successor of each
    key = prev.astype(np.int64) * v + cur.astype(np.int64)
    order = np.argsort(key, kind='stable')
    key_s, nxt_s = key[order], nxt[order]
    starts = np.flatnonzero(np.r_[True, key_s[1:] != key_s[:-1]])
    ends = np.r_[starts[1:], len(key_s)]
    for lo, hi in zip(starts, ends):
        vals, cnts = np.unique(nxt_s[lo:hi], return_counts=True)
        k = key_s[lo]
        trigram[k // v, k % v] = vals[np.argmax(cnts)]
    return {'bigram': bigram, 'trigram': trigram}


def save_draft(path: Union[str, Path], table) -> None:
    """A draft dict (its arrays by name) or a bare bigram table ('table')
    to a compressed .npz."""
    if isinstance(table, dict):
        np.savez_compressed(path, **table)
    else:
        np.savez_compressed(path, table=table)


def load_draft(path: Union[str, Path]) -> Optional[Union[np.ndarray, Dict[str, np.ndarray]]]:
    """``save_draft``'s file back: a draft dict, a bare table, or None if
    the file does not exist."""
    path = Path(path)
    if not path.exists():
        return None
    with np.load(path) as z:
        if 'trigram' in z:
            return {'bigram': z['bigram'], 'trigram': z['trigram']}
        return z['table']
