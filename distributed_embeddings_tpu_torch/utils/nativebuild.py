"""Build and load the port's native libraries: the counterpart of
``distributed_embeddings_tpu/utils/nativebuild.py``.

Two arms, one lifecycle:

- the CUDA kernels: each ``csrc/<name>.cu`` compiles with ``nvcc`` for
  ``sm_90a`` (``build`` / ``load``);
- the host libraries: each ``csrc/host/<name>.cc`` compiles with ``g++
  -O3 -std=c++17 -fPIC -shared -pthread`` (``build_host`` /
  ``load_host``; today the raw-binary loader, ``fastloader``).

Each is a shared library with a plain C interface, loaded with
``ctypes``.  It lands in ``build/torch_kernels/`` at the repository root
under a name that carries the hash of its source and flags, so an edited
source is rebuilt at its next use and a stale binary can never shadow
it.  Building happens at first use, never at import.

There is no fallback: a library that does not build raises, with the
compiler's output in the message.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
              '-lineinfo')

HOST_DIR = CSRC_DIR / 'host'
CXX_FLAGS = ('-O3', '-std=c++17', '-fPIC', '-shared', '-pthread')

_loaded: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class Built:
  """One compiled kernel library: its path, the seconds ``nvcc`` took
  (0.0 when an up-to-date library was found) and the compiler's output
  (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
  name: str
  path: Path
  seconds: float
  log: str


def nvcc() -> str:
  """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the
  ``PATH``, or ``/usr/local/cuda/bin/nvcc``."""
  candidates = [os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc']
  for c in candidates:
    if c and os.path.isfile(c):
      return c
  raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, PATH and '
                     '/usr/local/cuda/bin): the CUDA kernels need the CUDA '
                     'toolkit')


def library_path(name: str) -> Path:
  """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
  source, of every header in ``csrc/`` and of the flags."""
  h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  h.update((CSRC_DIR / f'{name}.cu').read_bytes())
  for header in sorted(CSRC_DIR.glob('*.cuh')):
    h.update(header.read_bytes())
  return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def build(name: str) -> Built:
  """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
  raise with the compiler's output if ``nvcc`` fails."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  path = library_path(name)
  if path.exists():
    return Built(name, path, 0.0, '')
  tmp = path.with_suffix(f'.so.tmp{os.getpid()}')
  cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / f'{name}.cu')]
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True)
  seconds = time.perf_counter() - t0
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f'CUDA kernel build failed: {name}: nvcc exited '
                       f'{proc.returncode}\n{proc.stdout}')
  os.replace(tmp, path)  # atomic: a concurrent build never sees half
  return Built(name, path, seconds, proc.stdout)


def load(name: str) -> ctypes.CDLL:
  """The loaded library of ``csrc/<name>.cu``, built first if needed."""
  lib = _loaded.get(name)
  if lib is None:
    lib = _loaded[name] = ctypes.CDLL(str(build(name).path))
  return lib


def cxx() -> str:
  """Path of the host C++ compiler: ``$CXX``, or ``g++`` / ``c++`` on the
  ``PATH``."""
  for c in (os.environ.get('CXX', ''), shutil.which('g++') or '',
            shutil.which('c++') or ''):
    if c and (os.path.isfile(c) or shutil.which(c)):
      return c
  raise RuntimeError('no C++ compiler found ($CXX, g++ or c++ on the '
                     'PATH): the host libraries need one')


def host_library_path(name: str) -> Path:
  """Where ``csrc/host/<name>.cc`` builds to (hash of source and
  flags in the name)."""
  h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
  h.update((HOST_DIR / f'{name}.cc').read_bytes())
  return BUILD_DIR / f'lib{name}-host-{h.hexdigest()[:16]}.so'


def build_host(name: str) -> Built:
  """Compile ``csrc/host/<name>.cc`` unless an up-to-date library
  exists; raise with the compiler's output if it fails."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  path = host_library_path(name)
  if path.exists():
    return Built(name, path, 0.0, '')
  tmp = path.with_suffix(f'.so.tmp{os.getpid()}')
  cmd = [cxx(), *CXX_FLAGS, '-o', str(tmp), str(HOST_DIR / f'{name}.cc')]
  t0 = time.perf_counter()
  proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                        stderr=subprocess.STDOUT, text=True)
  seconds = time.perf_counter() - t0
  if proc.returncode != 0:
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f'host library build failed: {name}: the compiler '
                       f'exited {proc.returncode}\n{proc.stdout}')
  os.replace(tmp, path)  # atomic: a concurrent build never sees half
  return Built(name, path, seconds, proc.stdout)


def load_host(name: str) -> ctypes.CDLL:
  """The loaded library of ``csrc/host/<name>.cc``, built first if
  needed."""
  key = f'host:{name}'
  lib = _loaded.get(key)
  if lib is None:
    lib = _loaded[key] = ctypes.CDLL(str(build_host(name).path))
  return lib
