"""Builds the port's CUDA sources (``csrc/*.cu``) into plain-C shared
libraries with ``nvcc`` and loads them with ``ctypes``.

A library is named after its source and a hash of the source and the
flags, so it is rebuilt only when either changes.  The build goes to
``build/kernels/`` at the repository root, which ``.gitignore`` lists.
Sources include no PyTorch header, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if home and (Path(home) / 'bin' / 'nvcc').is_file():
            return str(Path(home) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels are built on a '
                           'machine with the CUDA toolkit')
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    src = CSRC_DIR / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes() + ' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{digest.hexdigest()[:16]}.so'


def build(*names: str) -> Dict[str, Path]:
    """Builds the named sources that have no library yet, one ``nvcc`` per
    source, all started together.  Returns each library's path; the
    compiler's output (``-Xptxas=-v``: registers, spills) is kept beside it
    as ``<library>.log``.  Raises with the compiler's output on failure."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
        procs = {}
        for n, p in todo.items():
            tmp = p.with_name(f'{p.name}.{os.getpid()}.tmp')
            cmd = [compiler, *NVCC_FLAGS, '-o', str(tmp),
                   str(CSRC_DIR / f'{n}.cu')]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            p = todo[n]
            p.with_name(p.name + '.log').write_text(log)
            if proc.returncode:
                failed.append(f'{n}.cu:\n{log}')
            else:
                os.replace(tmp, p)   # atomic: a concurrent loader sees all or nothing
        if failed:
            raise RuntimeError('nvcc failed:\n' + '\n'.join(failed))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built on first use."""
    return ctypes.CDLL(str(build(name)[name]))
