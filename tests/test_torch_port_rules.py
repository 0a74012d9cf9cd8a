"""Rules of the PyTorch port that hold for every module of it:

- no module of ``distributed_embeddings_tpu_torch`` and not
  ``chip_smoke.py`` imports ``jax`` or ``distributed_embeddings_tpu``
  (an AST scan, so an import inside a function counts too);
- entry points run on ``cuda`` unless told ``device='cpu'``: without a
  card they raise instead of running on the CPU;
- kernels build from ``csrc/`` into a path named by the source's hash,
  and a missing compiler raises.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu_torch import layers
from distributed_embeddings_tpu_torch.examples.benchmarks import (
    lookup_benchmark)
from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
from distributed_embeddings_tpu_torch.layers import dist_embed
from distributed_embeddings_tpu_torch.models import dlrm, synthetic
from distributed_embeddings_tpu_torch.parallel import hotcache, mesh
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.serving.engine import ServingEngine
from distributed_embeddings_tpu_torch.utils import nativebuild

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / 'distributed_embeddings_tpu_torch').rglob('*.py'))
FORBIDDEN = ('jax', 'jaxlib', 'distributed_embeddings_tpu')


def _imported_roots(path):
  roots = set()
  for node in ast.walk(ast.parse(path.read_text(), str(path))):
    if isinstance(node, ast.Import):
      roots |= {a.name.split('.')[0] for a in node.names}
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      roots.add(node.module.split('.')[0])
  return roots


@pytest.mark.parametrize(
    'path', PORT_FILES + [ROOT / 'chip_smoke.py'],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_nothing_of_jax(path):
  bad = _imported_roots(path) & set(FORBIDDEN)
  assert not bad, f'{path.name} imports {sorted(bad)}'


def test_scan_sees_the_whole_port():
  names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
  for module in ('ops/lookup.py', 'ops/segwalk.py', 'parallel/planner.py',
                 'parallel/dist_embedding.py', 'parallel/sparse.py',
                 'parallel/grad.py', 'optim.py', 'serving/engine.py',
                 'models/dlrm.py', 'utils/schedules.py', 'utils/data.py',
                 'utils/metrics.py', 'examples/dlrm/main.py',
                 'parallel/checkpoint.py', 'parallel/audit.py',
                 'parallel/callbacks.py', 'utils/resilience.py',
                 'obs/trace.py', 'obs/metrics.py',
                 'tools/verify_checkpoint.py', 'ops/ragged.py',
                 'ops/embedding_lookup.py', 'layers/embedding.py',
                 'layers/dist_embed.py',
                 'examples/benchmarks/lookup_benchmark.py',
                 'parallel/hotcache.py', 'parallel/mesh.py',
                 'parallel/overlap.py', 'parallel/quantization.py',
                 'parallel/coldtier.py', 'utils/fastloader.py',
                 'examples/dlrm/gen_data.py', 'serving/frontend.py'):
    assert f'distributed_embeddings_tpu_torch/{module}' in names
  # the scan itself catches a forbidden import in a function body
  src = 'def f():\n  from distributed_embeddings_tpu.ops import x\n'
  tree = ast.parse(src)
  assert any(isinstance(n, ast.ImportFrom) and n.module.startswith(
      'distributed_embeddings_tpu.') for n in ast.walk(tree))


def _no_card():
  if torch.cuda.is_available():
    pytest.skip('a card is present: the cuda default is valid here')


def test_resolve_device_defaults_to_cuda_and_raises_without_card():
  _no_card()
  with pytest.raises(RuntimeError, match='no CUDA device'):
    mesh.resolve_device()
  with pytest.raises(RuntimeError, match='no CUDA device'):
    mesh.create_mesh()
  assert mesh.resolve_device('cpu') == torch.device('cpu')
  with pytest.raises(ValueError, match='unsupported device'):
    mesh.resolve_device('meta')


@pytest.mark.parametrize('entry', ['dist_embedding', 'synthetic', 'serving',
                                   'mlp', 'dlrm', 'dlrm_main', 'embedding',
                                   'concat_one_hot', 'dist_embed',
                                   'lookup_benchmark', 'hot_cache',
                                   'dlrm_main_hot_cache', 'two_axis_mesh'])
def test_entry_points_raise_without_device_argument(entry):
  _no_card()
  t = [TableConfig(10, 8, combiner='sum')]
  build = {
      'dist_embedding': lambda: DistributedEmbedding(t),
      'synthetic': lambda: synthetic.SyntheticModel(
          synthetic.SYNTHETIC_MODELS['tiny'], dp_input=True),
      'serving': lambda: ServingEngine(t, [np.zeros((10, 8), np.float32)],
                                       batch_size=8),
      'mlp': lambda: dlrm.MLP(4, [2]),
      'dlrm': lambda: dlrm.DLRM([10, 20], embedding_dim=8,
                                bottom_mlp_dims=[8]),
      'dlrm_main': lambda: dlrm_main.main(['--table_sizes', '10,20',
                                           '--num_batches', '1']),
      'embedding': lambda: layers.Embedding(10, 8),
      'concat_one_hot': lambda: layers.ConcatOneHotEmbedding([3, 4], 8),
      'dist_embed': lambda: dist_embed.DistEmbed.build(t),
      'lookup_benchmark': lambda: lookup_benchmark.main(
          ['--rows', '10', '--batch', '4']),
      'hot_cache': lambda: DistributedEmbedding(
          t, hot_cache={0: hotcache.HotSet(0, np.arange(3))}),
      'dlrm_main_hot_cache': lambda: dlrm_main.main(
          ['--table_sizes', '10,20', '--num_batches', '1', '--dp_input',
           '--hot_cache']),
      'two_axis_mesh': lambda: mesh.create_mesh(shape=(2, 2)),
  }[entry]
  with pytest.raises(RuntimeError, match="pass device='cpu'"):
    build()


def test_library_path_follows_the_source():
  path = nativebuild.library_path('lookup_combine')
  assert path.parent == ROOT / 'build' / 'torch_kernels'
  assert path.name.startswith('liblookup_combine-')
  assert path == nativebuild.library_path('lookup_combine')
  assert (nativebuild.CSRC_DIR / 'lookup_combine.cu').exists()
  assert 'arch=compute_90a,code=sm_90a' in nativebuild.NVCC_FLAGS


def test_every_kernel_source_builds_to_its_own_path():
  names = sorted(p.stem for p in nativebuild.CSRC_DIR.glob('*.cu'))
  assert names == ['lookup_combine', 'segwalk_apply']
  paths = {nativebuild.library_path(n) for n in names}
  assert len(paths) == len(names)
  assert all(p.parent == ROOT / 'build' / 'torch_kernels' for p in paths)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
  monkeypatch.setattr(nativebuild, 'BUILD_DIR', tmp_path)
  monkeypatch.setenv('CUDA_HOME', str(tmp_path))
  monkeypatch.setenv('PATH', str(tmp_path))
  monkeypatch.setattr(nativebuild.os.path, 'isfile',
                      lambda p: False)
  with pytest.raises(RuntimeError, match='nvcc not found'):
    nativebuild.build('lookup_combine')


def test_host_build_without_compiler_raises(monkeypatch, tmp_path):
  """The host arm (``csrc/host/*.cc``): no C++ compiler raises, and a
  failing compile raises with the compiler's output; nothing falls back."""
  monkeypatch.setattr(nativebuild, 'BUILD_DIR', tmp_path)
  monkeypatch.setenv('CXX', '')
  monkeypatch.setenv('PATH', str(tmp_path))
  with pytest.raises(RuntimeError, match='no C\\+\\+ compiler'):
    nativebuild.build_host('fastloader')
  assert not list(tmp_path.iterdir())


def test_host_library_path_follows_the_source():
  path = nativebuild.host_library_path('fastloader')
  assert path.parent == nativebuild.BUILD_DIR
  assert path.name.startswith('libfastloader-host-')
  assert (nativebuild.HOST_DIR / 'fastloader.cc').exists()
