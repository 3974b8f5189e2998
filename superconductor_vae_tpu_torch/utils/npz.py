"""npz round-trip helpers (port of utils/npz.py).

Training dumps (latent_cache.npz) may store bfloat16 arrays; plain
``np.load`` returns those as raw 2-byte void ('V2') records.  The JAX
package views them through ``ml_dtypes``; here the raw 16-bit words are
viewed as ``torch.bfloat16``, which needs nothing beyond torch.
"""

from __future__ import annotations

import numpy as np
import torch


def as_f32(a: np.ndarray) -> np.ndarray:
    """Coerce an array loaded from npz (possibly raw bfloat16) to float32."""
    a = np.asarray(a)
    if a.dtype.kind == 'V':
        if a.dtype.itemsize != 2:
            raise TypeError(f'as_f32: raw records of {a.dtype.itemsize} bytes are not '
                            'bfloat16')
        words = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return words.view(torch.bfloat16).float().numpy()
    return a.astype(np.float32)
