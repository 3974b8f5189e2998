"""Host-side copies in the port (tokenizer, formula parsing, the stdlib
CSV reader) against the JAX package on the first rows of the real corpus.
All comparisons are exact."""

from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from superconductor_vae_tpu.data.pipeline import (
    parse_formula_composition as jax_parse)
from superconductor_vae_tpu.tokenizer import default_tokenizer as jax_tokenizer
from superconductor_vae_tpu_torch.data import (
    composition_slots, parse_formula_composition, read_csv_rows)
from superconductor_vae_tpu_torch.tokenizer import default_tokenizer

import torch_port_threads  # noqa: F401  (one torch thread a process)

CSV = Path(__file__).resolve().parents[1] / 'data/processed/jarvis_merged.csv.gz'
N = 64


@pytest.fixture(scope='module')
def rows():
    return read_csv_rows(CSV, N)


def test_tokenizer_matches_jax_on_corpus(rows):
    port, ref = default_tokenizer(max_len=30), jax_tokenizer(max_len=30)
    assert port.vocab_size == ref.vocab_size == 4752
    for name in ('token_type_table', 'type_masks', 'fraction_value_table',
                 'token_value_table', 'token_to_element_z'):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    ids = port.encode_batch(rows['formula'])
    np.testing.assert_array_equal(ids, ref.encode_batch(rows['formula']))
    for row in ids:
        assert port.decode(row) == ref.decode(row)
        assert port.decode(row, strip_special=False) == ref.decode(row, strip_special=False)


def test_composition_matches_jax_on_corpus(rows):
    for f in rows['formula']:
        assert parse_formula_composition(f) == jax_parse(f)
    idx, frac, mask = composition_slots(rows['formula'])
    for i, f in enumerate(rows['formula']):
        comp = jax_parse(f)
        total = sum(comp.values())
        assert mask[i].sum() == min(len(comp), 12)
        np.testing.assert_allclose(frac[i, :mask[i].sum()],
                                   [a / total for a in list(comp.values())[:12]],
                                   rtol=1e-6)


def test_csv_reader_matches_pandas(rows):
    """The stdlib reader returns the columns and values the JAX loader
    takes with pandas (numeric columns minus its exclusion list)."""
    df = pd.read_csv(CSV, nrows=N)
    exclude = {'formula', 'Tc', 'composition', 'category', 'is_superconductor',
               'compound possible', 'formula_original', 'requires_high_pressure'}
    cols = [c for c in df.select_dtypes(include=['number']).columns if c not in exclude]
    assert rows['magpie_columns'] == cols and len(cols) == 78
    np.testing.assert_array_equal(rows['magpie'], df[cols].values.astype(np.float32))
    np.testing.assert_array_equal(rows['tc'], df['Tc'].fillna(0.0).values)
    np.testing.assert_array_equal(rows['is_sc'], df['is_superconductor'].values)
    assert rows['formula'] == df['formula'].astype(str).tolist()


def test_csv_reader_reads_plain_csv_and_empty_cells(tmp_path):
    path = tmp_path / 'rows.csv'
    path.write_text('formula,Tc,source,is_superconductor,magpie_a,z_mean\n'
                    'NbTi,9.2,x,1,1.5,\nMgB2,,y,0,,2\nCu,1,z,1,3,4\n')
    got = read_csv_rows(path, 2)
    assert got['formula'] == ['NbTi', 'MgB2'] and got['magpie_columns'] == ['magpie_a', 'z_mean']
    np.testing.assert_array_equal(got['tc'], [9.2, 0.0])
    np.testing.assert_array_equal(np.isnan(got['magpie']), [[False, True], [True, False]])
