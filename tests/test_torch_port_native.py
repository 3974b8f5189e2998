"""The port's native tokenizer and composition parser (native/), built by
g++ from the port's own copy of the source into build/native/:
- tokens equal the port's Python tokenizer and the JAX package's native
  module, and parsed compositions equal the port's ``composition_slots``
  and JAX's native parse, bit for bit, on the edge cases of
  tests/test_native.py and the first 2,000 rows of the corpus;
- the source is the JAX package's, byte for byte;
- a build that fails raises with the compiler's output (no fallback),
  and ``load_dataset(native=False)`` gives the native path's arrays.
"""

from pathlib import Path

import numpy as np
import pytest

from superconductor_vae_tpu import native as jax_native
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu_torch import native
from superconductor_vae_tpu_torch.data import composition_slots, read_csv_rows
from superconductor_vae_tpu_torch.data import pipeline
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
import torch_port_threads  # noqa: F401  (one torch thread a process)

ROOT = Path(__file__).resolve().parents[1]
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'
EDGE = ['', '???', 'Y1Ba2Cu3{18}O7', '{999}O', 'O21', 'Cu(0/0)', 'La(6/10)Sr(4/10)CuO4',
        'CuO' * 60, 'xyzCu', 'H(1019949/100000)', 'Ba0.2La1.8CuO4', 'La1.85Sr0.15CuO4',
        'Y0.6Ca0.4Ba2Cu3O7', 'Mg0.5B2', 'Fe1.01Se0.99', 'Nb3Sn', 'H.5O', 'C0.125Mo6Se8',
        '18OCu', 'NaCl(1/2)']


@pytest.fixture(scope='module')
def formulas():
    return EDGE + read_csv_rows(CSV, 2000)['formula']


def test_source_is_the_jax_packages():
    assert native.SRC.read_bytes() == (
        ROOT / 'superconductor_vae_tpu/native/src/formula_tokenizer.cpp').read_bytes()
    assert native.build() == native.library_path()
    assert native.library_path().parent == ROOT / 'build' / 'native'


def test_tokens_equal_python_and_jax(formulas):
    tok = default_tokenizer(max_len=30)
    got = native.tokenize_batch(formulas, tok)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, tok.encode_batch(formulas))
    np.testing.assert_array_equal(got, jax_native.tokenize_batch(formulas,
                                                                 jax_tokenizer(max_len=30)))
    # a second vocabulary (another max_len) in the same process
    np.testing.assert_array_equal(native.tokenize_batch(EDGE, default_tokenizer(max_len=12)),
                                  default_tokenizer(max_len=12).encode_batch(EDGE))


def test_compositions_equal_python_and_jax(formulas):
    tok = default_tokenizer(max_len=30)
    got = native.parse_compositions(formulas, tok)
    want = composition_slots(formulas)
    jax_got = jax_native.parse_compositions(formulas, jax_tokenizer(max_len=30))
    for g, w, j in zip(got, want, jax_got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    bad = tmp_path / 'broken.cpp'
    bad.write_text('int main( {\n')
    monkeypatch.setattr(native, 'SRC', bad)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed on broken.cpp') as e:
        native.build()
    assert 'error' in str(e.value)
    assert not list((tmp_path / 'build').glob('*.so'))


def test_load_dataset_native_and_python_paths_agree(tmp_path):
    rows = CSV
    small = tmp_path / 'small.csv'
    import gzip
    with gzip.open(rows, 'rt') as f:
        small.write_text(''.join(next(f) for _ in range(301)))
    a = pipeline.load_dataset(small, native=True, order_augment=2)
    b = pipeline.load_dataset(small, native=False, order_augment=2)
    assert len(a) > 300
    for k in ('tokens', 'element_indices', 'element_fractions', 'element_mask', 'magpie'):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
