"""What the port reads of a checkpoint's ``meta.json`` (port of
checkpoint/io.py; saving and restoring come with the host loop, A.11)."""

from __future__ import annotations

from typing import Dict


def ckpt_skew_transform(meta: Dict) -> str:
    """The Magpie skew transform a checkpoint's params were trained under.
    Checkpoints saved before the 'data_norm' meta key (run3, run4) trained
    on the legacy jittered rank-gauss corpus, and offline eval must reload
    the corpus with the same transform or every encoder input shifts."""
    return (meta.get('data_norm') or {}).get('skew_transform', 'rank_gauss')
