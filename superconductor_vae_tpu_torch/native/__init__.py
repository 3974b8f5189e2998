"""ctypes bindings for the native C++ formula tokenizer and composition
parser (port of native/__init__.py).

``src/formula_tokenizer.cpp`` is built on first use with
``g++ -O3 -std=c++17 -shared -fPIC`` into ``build/native/`` at the
repository root (which ``.gitignore`` lists), under a name holding a hash
of the source and the flags, so it is rebuilt only when either changes
(as ``ops/_build.py`` builds the CUDA kernels).  Unlike the JAX package's
binding, which falls back to Python in silence when the build fails, a
failed build raises with the compiler's output: a caller that wants the
pure-Python tokenizer and parser asks for them (``load_dataset(...,
native=False)``), and they stay the plain versions the tests hold this
module to.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / 'src' / 'formula_tokenizer.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
GXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')

_lock = threading.Lock()
_vocab_key = None       # the (fractions, isotopes) the library was initialised with


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + ' '.join(GXX_FLAGS).encode())
    return BUILD_DIR / f'formula_tokenizer-{digest.hexdigest()[:16]}.so'


def build() -> Path:
    """Builds the library unless it exists; returns its path.  Raises
    ``RuntimeError`` with the compiler's output when ``g++`` fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f'{path.name}.{os.getpid()}.tmp')
    try:
        proc = subprocess.run(['g++', *GXX_FLAGS, str(SRC), '-o', str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError('g++ not found: the native tokenizer is built with g++') from e
    if proc.returncode:
        raise RuntimeError(f'g++ failed on {SRC.name}:\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or nothing
    return path


@functools.cache
def load() -> ctypes.CDLL:
    """The library, built on first use, with its argument types set."""
    lib = ctypes.CDLL(str(build()))
    lib.sc_init.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
    lib.sc_tokenize_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                      ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
    lib.sc_tokenize_batch.restype = ctypes.c_int
    lib.sc_parse_compositions.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8)]
    lib.sc_parse_compositions.restype = ctypes.c_int
    return lib


def _c_strings(strings: List[str]):
    arr = (ctypes.c_char_p * len(strings))()
    encoded = [s.encode() for s in strings]
    arr[:] = encoded
    return arr, encoded  # keep the bytes alive while the library reads them


def _init(tokenizer) -> ctypes.CDLL:
    """The library with its vocabulary set to ``tokenizer``'s fractions and
    isotopes (set again when another vocabulary comes)."""
    global _vocab_key
    lib = load()
    key = (tuple(tokenizer.fractions), tuple(tokenizer.isotopes))
    if key != _vocab_key:
        fr, _k1 = _c_strings(list(key[0]))
        iso, _k2 = _c_strings(list(key[1]))
        lib.sc_init(fr, len(key[0]), iso, len(key[1]))
        _vocab_key = key
    return lib


def tokenize_batch(formulas: List[str], tokenizer, max_len: int | None = None) -> np.ndarray:
    """[N, max_len] int32 token ids, as ``tokenizer.encode_batch``."""
    max_len = max_len or tokenizer.max_len
    out = np.zeros((len(formulas), max_len), np.int32)
    arr, _keep = _c_strings(formulas)
    with _lock:
        rc = _init(tokenizer).sc_tokenize_batch(
            arr, len(formulas), max_len, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f'sc_tokenize_batch returned {rc}')
    return out


def parse_compositions(formulas: List[str], tokenizer, max_elements: int = 12
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(element_indices int32, element_fractions float32, element_mask
    bool), each [N, max_elements], as the pipeline's
    ``composition_slots``."""
    n = len(formulas)
    idx = np.zeros((n, max_elements), np.int32)
    frac = np.zeros((n, max_elements), np.float32)
    mask = np.zeros((n, max_elements), np.uint8)
    arr, _keep = _c_strings(formulas)
    with _lock:
        rc = _init(tokenizer).sc_parse_compositions(
            arr, n, max_elements,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            frac.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f'sc_parse_compositions returned {rc}')
    return idx, frac, mask.astype(bool)
