"""Orbax PyTree snapshots, read without tensorstore, Orbax or JAX (the
counterpart of the JAX package's checkpoint/io.py ``load_checkpoint``,
which restores them through Orbax).

A snapshot's ``state/`` directory is an OCDBT key-value store, in
tensorstore's published OCDBT storage format:
- ``manifest.ocdbt``: a header (magic 0x0cdb3a2a, the file's length, the
  format version, the body's compression), the body (the store's config,
  a table of data files, the newest versions of the B+tree, each with its
  root node's location) and a CRC-32C of all that precedes it.  Orbax
  writes one store a process (``ocdbt.process_0/``) and a top store whose
  B+tree refers into theirs, so the top manifest is the one read.
- B+tree nodes, each inside a data file under ``d/`` at an offset and
  length: the same header (magic 0x0cdb20de), a zstd-compressed body and a
  CRC-32C.  A body holds the node's height, its own table of data files
  and its entries in columns: keys prefix-compressed against the entry
  before; in a leaf, each value inline or as a (data file, offset,
  length) reference; in an interior node, each child's location and the
  key prefix common to its subtree, which the child's keys leave out.
  Integers are LEB128 varints unless said otherwise.
- Each array of the tree is a zarr v2 array under the key of its path
  joined by dots: ``<path>/.zarray`` (JSON: shape, chunks, dtype, order,
  compressor) and one key a chunk (``0``, ``0.0``, ...), each a zstd
  frame.  bfloat16 comes out as raw 16-bit words, numpy's ``V2`` records,
  as an npz of bf16 does (``utils/npz.py`` ``as_f32`` widens them).
- ``_METADATA`` (JSON, beside the store) gives each leaf's path in the
  tree (an empty list is a leaf of type 'List' there, with no array); the
  tree comes back as the nested dicts that the JAX package's
  ``load_checkpoint`` returns.

zstd is libzstd's own, loaded through ctypes (``LIBZSTD_NAMES``): no
Python package is installed for it, and if the library cannot be loaded
the read raises and says where the loader looked.  Every read is checked:
the headers, the lengths, the CRC-32Cs of the manifest and the nodes, and
each chunk's decompressed size; a failure raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

LIBZSTD_NAMES = ('libzstd.so.1',)
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_HEADER = 14                  # magic (4, big-endian), length (8), version, compression
_ZSTD_UNKNOWN = 2 ** 64 - 1   # ZSTD_CONTENTSIZE_UNKNOWN
_ZSTD_ERROR = 2 ** 64 - 2     # ZSTD_CONTENTSIZE_ERROR
_MAX_BODY = 1 << 30           # a manifest's or node's body, decompressed
# zarr v2 dtype strings -> numpy; bfloat16 as raw 16-bit words
_DTYPES = {'bfloat16': np.dtype('V2'), '|b1': np.dtype(bool), 'bool': np.dtype(bool)}

# an entry's value: inline bytes, or (data file path, offset, length)
ValueRef = Union[bytes, Tuple[Path, int, int]]


class SnapshotError(ValueError):
    """A snapshot that does not read as the format says."""


# ---- zstd through libzstd -----------------------------------------------------------

class Zstd:
    """libzstd's one-shot decompression (``ZSTD_getFrameContentSize``,
    ``ZSTD_decompress``) through ctypes."""

    def __init__(self):
        errors = []
        for name in LIBZSTD_NAMES:
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError as e:
                errors.append(f'{name}: {e}')
        else:
            raise OSError(
                'libzstd cannot be loaded; tried ' + '; '.join(errors) + '. The dynamic '
                f'loader searched LD_LIBRARY_PATH={os.environ.get("LD_LIBRARY_PATH", "")!r}, '
                'the ld.so cache (ldconfig -p) and the default directories (/lib, /usr/lib)')
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_char_p, ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        self.lib = lib

    def content_size(self, src: bytes) -> Optional[int]:
        """The frame's decompressed size, or None where the frame does not
        record it."""
        n = self.lib.ZSTD_getFrameContentSize(src, len(src))
        if n == _ZSTD_ERROR:
            raise SnapshotError('not a zstd frame')
        return None if n == _ZSTD_UNKNOWN else n

    def _into(self, dst: np.ndarray, src: bytes) -> int:
        r = self.lib.ZSTD_decompress(dst.ctypes.data, dst.nbytes, src, len(src))
        if self.lib.ZSTD_isError(r):
            raise SnapshotError(f'zstd: {self.lib.ZSTD_getErrorName(r).decode()}')
        return r

    def decompress_into(self, dst: np.ndarray, src: bytes) -> None:
        """Decompresses ``src`` into the contiguous array ``dst``, which it
        must fill exactly."""
        size = self.content_size(src)
        if size is not None and size != dst.nbytes:
            raise SnapshotError(f'zstd frame of {size} bytes where {dst.nbytes} are due')
        n = self._into(dst.reshape(-1).view(np.uint8), src)
        if n != dst.nbytes:
            raise SnapshotError(f'zstd frame gave {n} bytes where {dst.nbytes} are due')

    def decompress(self, src: bytes, limit: int) -> bytes:
        """``src`` decompressed, at most ``limit`` bytes."""
        size = self.content_size(src)
        cap = size if size is not None else min(limit, max(1 << 16, 8 * len(src)))
        while True:
            if cap > limit:
                raise SnapshotError(f'zstd frame larger than {limit} bytes')
            buf = np.empty(cap, np.uint8)
            try:
                n = self._into(buf, src)
            except SnapshotError:
                if size is not None or cap == limit:
                    raise
                cap = min(2 * cap, limit)          # the frame does not say its size
                continue
            return buf[:n].tobytes()


# ---- OCDBT --------------------------------------------------------------------------

def _crc32c_table() -> Tuple[int, ...]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return tuple(table)


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as OCDBT's manifests and nodes carry it."""
    crc, table = 0xFFFFFFFF, _CRC32C_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """A cursor over a decoded body."""

    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            if self.pos >= len(self.buf):
                raise SnapshotError(f'{self.what}: ends inside a varint')
            byte = self.buf[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise SnapshotError(f'{self.what}: varint longer than 64 bits')

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise SnapshotError(f'{self.what}: ends {self.pos + n - len(self.buf)} bytes early')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def uint(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _open_encoded(raw: bytes, magic: int, what: str, zstd: Zstd) -> bytes:
    """The body of an encoded manifest or node, its header, length and
    CRC-32C checked."""
    if len(raw) < _HEADER + 4:
        raise SnapshotError(f'{what}: {len(raw)} bytes')
    got_magic, length = struct.unpack('>I', raw[:4])[0], struct.unpack('<Q', raw[4:12])[0]
    if got_magic != magic:
        raise SnapshotError(f'{what}: magic {got_magic:#010x}, not {magic:#010x}')
    if length != len(raw):
        raise SnapshotError(f'{what}: header says {length} bytes, read {len(raw)}')
    if crc32c(raw[:-4]) != struct.unpack('<I', raw[-4:])[0]:
        raise SnapshotError(f'{what}: CRC-32C mismatch')
    head = _Reader(raw[12:-4], what)
    if head.varint() != 0:
        raise SnapshotError(f'{what}: unknown format version')
    compression = head.varint()
    body = raw[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body, _MAX_BODY)
    raise SnapshotError(f'{what}: unknown compression {compression}')


def _data_file_table(r: _Reader, root: Path) -> List[Path]:
    """The data files a manifest or node refers to, each a path under the
    store's root: prefix-compressed full paths (base path + relative path)."""
    n = r.varint()
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    r.varints(n)                                       # base path lengths
    paths, prev = [], b''
    for i in range(n):
        full = prev[:prefix[i - 1] if i else 0] + r.take(suffix[i])
        paths.append(full)
        prev = full
    out = []
    for p in paths:
        rel = Path(p.decode())
        if rel.is_absolute() or '..' in rel.parts:
            raise SnapshotError(f'data file {p!r} outside the store')
        out.append(root / rel)
    return out


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """The entries' keys and, in an interior node, the length of the key
    prefix common to each child's subtree (its column lies between the
    key lengths and the key bytes)."""
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b''
    for i in range(n):
        key = prev[:prefix[i - 1] if i else 0] + r.take(suffix[i])
        keys.append(key)
        prev = key
    return keys, common


def _read_range(path: Path, offset: int, length: int) -> bytes:
    with open(path, 'rb') as f:
        f.seek(offset)
        data = f.read(length)
    if len(data) != length:
        raise SnapshotError(f'{path}: {length} bytes due at offset {offset}, read {len(data)}')
    return data


class OcdbtStore:
    """The newest version of an OCDBT store: ``entries`` maps each key to
    its value (``ValueRef``); ``read`` gives a value's bytes."""

    def __init__(self, root: str | Path, zstd: Optional[Zstd] = None):
        self.root = Path(root)
        self.zstd = zstd or Zstd()
        manifest = self.root / 'manifest.ocdbt'
        body = _open_encoded(manifest.read_bytes(), MANIFEST_MAGIC, str(manifest), self.zstd)
        r = _Reader(body, str(manifest))
        r.take(16)                                     # uuid
        if r.varint() != 0:
            raise SnapshotError(f'{manifest}: a numbered manifest; only single ones are read')
        r.varint(), r.varint()                         # max inline value, node bytes
        r.byte()                                       # version tree arity (log2)
        if r.varint() == 1:                            # zstd, then its level as int32
            r.uint('<i')
        files = _data_file_table(r, self.root)
        n = r.varint()                                 # the inline versions, in columns
        generation = r.varints(n)
        height = [r.byte() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        r.varints(n), r.varints(n)                     # tree bytes, indirect value bytes
        if n == 0:
            raise SnapshotError(f'{manifest}: no version inline')
        v = max(range(n), key=generation.__getitem__)
        self.entries: Dict[bytes, ValueRef] = {}
        if num_keys[v]:
            self._walk(files[file_id[v]], offset[v], length[v], height[v], b'')
        if len(self.entries) != num_keys[v]:
            raise SnapshotError(f'{manifest}: {len(self.entries)} keys, the version says '
                                f'{num_keys[v]}')

    def _walk(self, path: Path, offset: int, length: int, height: int, prefix: bytes):
        what = f'{path}@{offset}'
        body = _open_encoded(_read_range(path, offset, length), NODE_MAGIC, what, self.zstd)
        r = _Reader(body, what)
        if r.byte() != height:
            raise SnapshotError(f'{what}: not of height {height}')
        files = _data_file_table(r, self.root)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)
        if height == 0:
            lengths, kinds = r.varints(n), r.varints(n)
            n_ind = sum(k == 1 for k in kinds)
            if any(k not in (0, 1) for k in kinds):
                raise SnapshotError(f'{what}: unknown value kind')
            ind_file, ind_offset = r.varints(n_ind), r.varints(n_ind)
            j = 0
            for key, size, kind in zip(keys, lengths, kinds):
                if kind == 0:
                    self.entries[prefix + key] = r.take(size)
                else:
                    self.entries[prefix + key] = (files[ind_file[j]], ind_offset[j], size)
                    j += 1
            if r.pos != len(body):
                raise SnapshotError(f'{what}: {len(body) - r.pos} bytes left over')
            return
        child_file, child_offset, child_length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(n), r.varints(n), r.varints(n)       # keys, tree bytes, indirect bytes
        for i in range(n):
            self._walk(files[child_file[i]], child_offset[i], child_length[i], height - 1,
                       prefix + keys[i][:common[i]])

    def read(self, key: bytes) -> bytes:
        ref = self.entries[key]
        return ref if isinstance(ref, bytes) else _read_range(*ref)


# ---- zarr v2 arrays and the tree ----------------------------------------------------

def _dtype(name: str) -> np.dtype:
    if name in _DTYPES:
        return _DTYPES[name]
    dt = np.dtype(name)
    if dt.kind not in 'biuf':
        raise SnapshotError(f'zarr dtype {name!r} is not read')
    return dt


def read_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of the store: its chunks decompressed and
    laid out in C order, edge chunks cut to the array's shape."""
    meta = json.loads(store.read(f'{name}/.zarray'.encode()))
    if meta.get('zarr_format') != 2 or meta.get('order', 'C') != 'C' or meta.get('filters'):
        raise SnapshotError(f'{name}: zarr metadata not read: {meta}')
    if (meta.get('compressor') or {}).get('id') != 'zstd':
        raise SnapshotError(f'{name}: compressor {meta.get("compressor")}, not zstd')
    shape, chunks = tuple(meta['shape']), tuple(meta['chunks'])
    dtype = _dtype(meta['dtype'])
    sep = meta.get('dimension_separator', '.')
    out = np.empty(shape, dtype.newbyteorder('=') if dtype.kind in 'iuf' else dtype)
    if out.size == 0:
        return out
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    chunk = np.empty(chunks, dtype)
    for index in np.ndindex(*grid):
        key = f'{name}/{sep.join(map(str, index)) if index else "0"}'.encode()
        if key not in store.entries:
            raise SnapshotError(f'{name}: chunk {key.decode()} is missing')
        store.zstd.decompress_into(chunk, store.read(key))
        lo = [i * c for i, c in zip(index, chunks)]
        hi = [min(a + c, s) for a, c, s in zip(lo, chunks, shape)]
        out[tuple(slice(a, b) for a, b in zip(lo, hi))] = \
            chunk[tuple(slice(0, b - a) for a, b in zip(lo, hi))]
    return out


def is_orbax_snapshot(path: str | Path) -> bool:
    """Whether ``path`` is an Orbax snapshot directory (``state/`` with
    Orbax's ``_CHECKPOINT_METADATA``)."""
    return (Path(path) / 'state' / '_CHECKPOINT_METADATA').is_file()


def read_snapshot(state: str | Path, zstd: Optional[Zstd] = None) -> Dict[str, Any]:
    """An Orbax PyTree snapshot's ``state/`` directory as the nested dict of
    numpy arrays that the JAX package's ``load_checkpoint`` restores: dict
    keys as saved, sequences as lists."""
    state = Path(state)
    tree_meta = json.loads((state / '_METADATA').read_text())
    if not tree_meta.get('use_ocdbt', True) or tree_meta.get('use_zarr3'):
        raise SnapshotError(f'{state}: only OCDBT stores of zarr v2 arrays are read')
    store = OcdbtStore(state, zstd)
    tree: Dict[str, Any] = {}
    for entry in tree_meta['tree_metadata'].values():
        keys = entry['key_metadata']
        value_type = entry['value_metadata']['value_type']
        if value_type == 'List':          # an empty list, kept in the metadata alone
            leaf = []
        elif value_type in ('np.ndarray', 'jax.Array'):
            leaf = read_array(store, '.'.join(str(k['key']) for k in keys))
        else:
            raise SnapshotError(f'{state}: leaf {keys} of type {value_type!r} is not read')
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k['key'], {})
        node[keys[-1]['key']] = leaf
    return _sequences_as_lists(tree, tree_meta['tree_metadata'])


def _sequences_as_lists(tree, tree_metadata):
    """Dicts saved from sequences (key type 1) back as lists."""
    seq_paths = set()
    for entry in tree_metadata.values():
        keys = entry['key_metadata']
        for depth, k in enumerate(keys):
            if k['key_type'] == 1:
                seq_paths.add(tuple(str(x['key']) for x in keys[:depth]))
    if not seq_paths:
        return tree

    def rebuild(node, path):
        if not isinstance(node, dict):
            return node
        node = {k: rebuild(v, path + (str(k),)) for k, v in node.items()}
        if path in seq_paths:
            return [node[k] for k in sorted(node, key=int)]
        return node
    return rebuild(tree, ())


def array_digests(tree: Dict[str, Any]) -> Dict[str, List]:
    """{dotted path: [dtype, shape, SHA-256 of the C-order bytes]} of every
    array of a tree that ``read_snapshot`` returned (bfloat16 named so),
    in the order of its paths."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            a = np.ascontiguousarray(node)
            name = 'bfloat16' if a.dtype == np.dtype('V2') else str(a.dtype)
            out['.'.join(path)] = [name, list(a.shape), hashlib.sha256(a.tobytes()).hexdigest()]
    walk(tree, ())
    return dict(sorted(out.items()))
