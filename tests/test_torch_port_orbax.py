"""The port's reader of Orbax PyTree snapshots (checkpoint/ocdbt.py), which
needs no tensorstore, Orbax or JAX, against Orbax, tensorstore and the JAX
package's ``load_checkpoint``: the committed run4 snapshot (every array
bit for bit, and the SHA-256 table that chip_smoke.py checks its read
against), a tiny snapshot written by the JAX package's ``save_checkpoint``
(optimizer leaf lists, float64 and bool leaves), an Orbax array in
several chunks, a tensorstore store of several B+tree levels with edge
chunks, the eval CLI on a snapshot against the CLI on an npz of the same
params, the Phase-2 CLI on a snapshot, and the refusals: a corrupted chunk, node or data file, and a
libzstd that cannot be loaded."""

import dataclasses
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from superconductor_vae_tpu.checkpoint import load_checkpoint as jax_load_checkpoint
from superconductor_vae_tpu_torch.checkpoint import is_orbax_snapshot, load_checkpoint, ocdbt
from superconductor_vae_tpu_torch.models import tiny_test_config
from superconductor_vae_tpu_torch.scripts import evaluate as cli
from superconductor_vae_tpu_torch.scripts import phase2_standalone

import torch_port_threads  # noqa: F401  (one torch thread a process)
from torch_port_common import export_params_npz, head_csv, save_tiny_snapshot

ROOT = Path(__file__).resolve().parents[1]
RUN4 = ROOT / 'results/run4/ckpt_snapshot'
SHA256 = Path(__file__).with_name('torch_port_run4_sha256.json')
CSV = ROOT / 'data/processed/jarvis_merged.csv.gz'


def _assert_trees_equal(got, want):
    """The same paths (lists as lists), shapes, dtypes (bfloat16 as raw
    16-bit words) and bytes."""
    gl = jax.tree_util.tree_flatten_with_path(got)[0]
    wl = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        w = np.asarray(w)
        assert isinstance(g, np.ndarray) and g.shape == w.shape, path
        if w.dtype.name == 'bfloat16':
            assert g.dtype == np.dtype('V2'), path
        else:
            assert g.dtype == w.dtype, path
        assert g.tobytes() == w.tobytes(), path
    return len(gl)


def test_run4_snapshot_equals_orbax_and_the_digest_table():
    want, want_meta = jax_load_checkpoint(RUN4)
    assert is_orbax_snapshot(RUN4)
    got, meta = load_checkpoint(RUN4)
    assert meta == want_meta
    assert _assert_trees_equal(got, want) == 570
    assert sorted(got) == ['dec_params', 'enc_params', 'mastery', 'pz_params', 'set_params',
                           'step']
    assert {str(np.asarray(x).dtype) for x in jax.tree.leaves(want)} == {
        'bfloat16', 'bool', 'float64', 'int32'}
    assert sum(np.asarray(x).size for x in jax.tree.leaves(want)) == 146_537_621
    table = json.loads(SHA256.read_text())
    # the table is Orbax's read, and the port's read gives it
    assert ocdbt.array_digests(jax.tree.map(np.asarray, want)) == table
    assert ocdbt.array_digests(got) == table


def test_run4_store_equals_tensorstore():
    state = RUN4 / 'state'
    store = ocdbt.OcdbtStore(state)
    kv = ts.KvStore.open({'driver': 'ocdbt', 'base': f'file://{state}/'}).result()
    keys = kv.list().result()
    assert len(keys) == 1140
    assert sorted(store.entries) == sorted(keys)
    for key in keys:
        assert store.read(key) == kv[key], key


@pytest.fixture(scope='module')
def snapshot(tmp_path_factory):
    """A tiny snapshot from the JAX package's save_checkpoint at magpie_dim
    78 and max_len 30 (``save_tiny_snapshot``), and a CSV of the corpus's
    first 48 rows."""
    tmp = tmp_path_factory.mktemp('orbax')
    cfg = dataclasses.replace(tiny_test_config(), magpie_dim=78, max_len=30)
    return save_tiny_snapshot(tmp / 'ckpt', cfg), head_csv(CSV, tmp / 'head.csv', 48)


def test_tiny_snapshot_equals_jax(snapshot):
    path, _ = snapshot
    want, want_meta = jax_load_checkpoint(path)
    got, meta = load_checkpoint(path)
    assert meta == want_meta
    assert isinstance(got['enc_opt'], list) and len(got['enc_opt']) == len(want['enc_opt'])
    assert _assert_trees_equal(got, want) > 20
    assert got['step'].dtype == np.int32 and int(got['step']) == 7


def test_chunks_and_b_tree_levels(tmp_path):
    """A jax.Array sharded 4 x 2, which Orbax writes as 8 chunks; then a
    zarr array of edge chunks (10 x 7 in 4 x 3) in an OCDBT store of
    64-byte-limited nodes (a B+tree of several levels), written by
    tensorstore."""
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ('a', 'b'))
    rng = np.random.default_rng(0)
    big = jax.device_put(jnp.asarray(rng.standard_normal((12, 6)), jnp.bfloat16),
                         NamedSharding(mesh, PartitionSpec('a', 'b')))
    with ocp.PyTreeCheckpointer() as ckptr:
        ckptr.save(tmp_path / 'sharded' / 'state', {'w': big, 'n': np.arange(5, dtype=np.int32)})
        want = ckptr.restore(tmp_path / 'sharded' / 'state')
    store = ocdbt.OcdbtStore(tmp_path / 'sharded' / 'state')
    assert sum(k.startswith(b'w/') and not k.endswith(b'.zarray') for k in store.entries) == 8
    _assert_trees_equal(ocdbt.read_snapshot(tmp_path / 'sharded' / 'state'),
                        jax.tree.map(np.asarray, want))

    root = tmp_path / 'levels'
    kv = {'driver': 'ocdbt', 'base': f'file://{root}/',
          'config': {'max_decoded_node_bytes': 64, 'max_inline_value_bytes': 16}}
    data = rng.standard_normal((10, 7)).astype('<f4')
    arr = ts.open({'driver': 'zarr', 'kvstore': kv, 'path': 'x',
                   'metadata': {'shape': [10, 7], 'chunks': [4, 3], 'dtype': '<f4',
                                'compressor': {'id': 'zstd', 'level': 1}}},
                  create=True).result()
    arr.write(data).result()
    store = ocdbt.OcdbtStore(root)
    keys = ts.KvStore.open(kv).result().list().result()
    assert sorted(store.entries) == sorted(keys) and len(keys) == 1 + 3 * 3
    np.testing.assert_array_equal(ocdbt.read_array(store, 'x'), data)


def test_eval_cli_on_a_snapshot_equals_the_npz(snapshot, tmp_path):
    path, head = snapshot
    npz = tmp_path / 'params.npz'
    export_params_npz(jax_load_checkpoint(path)[0], npz)
    common = ['--csv', str(head), '--cpu', '--limit', '8', '--batch-size', '8']
    got = cli.main(['--checkpoint', str(path)] + common)
    want = cli.main(['--params', str(npz), '--meta', str(path / 'meta.json')] + common)
    for summary in (got, want):
        summary.pop('eval_wall_s')
        summary.pop('formulas_per_s')
    assert got.pop('checkpoint') == str(path) and want.pop('checkpoint') == str(path)
    assert got == want and got['n_evaluated'] == 8


def test_phase2_cli_on_a_snapshot(snapshot, tmp_path):
    path, head = snapshot
    phase2_standalone.main(['--checkpoint', str(path), '--csv', str(head), '--cpu',
                            '--sub-epochs', '1', '--n-samples', '8',
                            '--out-dir', str(tmp_path / 'p2')])
    log = [json.loads(x) for x in (tmp_path / 'p2/phase2_log.jsonl').read_text().splitlines()]
    assert [r['sub_epoch'] for r in log] == [0] and log[0]['metrics']['n_sampled'] == 8


def _copy(snapshot_dir, tmp_path):
    dst = tmp_path / 'copy'
    shutil.copytree(snapshot_dir, dst)
    return dst / 'state'


def _largest_indirect(state):
    store = ocdbt.OcdbtStore(state)
    refs = [v for v in store.entries.values() if not isinstance(v, bytes)]
    return max(refs, key=lambda r: r[2])


@pytest.mark.parametrize('what', ['chunk', 'node', 'data file'])
def test_a_damaged_snapshot_raises(snapshot, tmp_path, what):
    state = _copy(snapshot[0], tmp_path)
    if what == 'chunk':                  # the block header of the largest chunk's frame
        file, offset, _ = _largest_indirect(state)
        raw = bytearray(file.read_bytes())
        raw[offset + 6:offset + 12] = b'\xff' * 6
        file.write_bytes(bytes(raw))
    elif what == 'node':                 # one byte inside the top B+tree node
        node = next((state / 'd').iterdir())
        raw = bytearray(node.read_bytes())
        raw[len(raw) // 2] ^= 0x01
        node.write_bytes(bytes(raw))
    else:                                # a data file cut short
        file, offset, length = _largest_indirect(state)
        file.write_bytes(file.read_bytes()[:offset + length // 2])
    with pytest.raises(ocdbt.SnapshotError):
        ocdbt.read_snapshot(state)


def test_missing_libzstd_raises(snapshot, monkeypatch, tmp_path):
    missing = str(tmp_path / 'libzstd.so.1')
    monkeypatch.setattr(ocdbt, 'LIBZSTD_NAMES', (missing,))
    with pytest.raises(OSError, match='libzstd cannot be loaded') as e:
        ocdbt.read_snapshot(snapshot[0] / 'state')
    assert missing in str(e.value) and 'LD_LIBRARY_PATH' in str(e.value)
