"""The split-binary Criteo data path (item 12): the port's writer,
``gen_data.py``, its Python reader and its native reader (the port's
copy of ``cc/fastloader.cc``, built with ``g++`` by
``utils/nativebuild.py``) against the JAX package's, on files the tests
write.

- ``write_raw_binary_dataset`` and ``gen_data.py`` write the JAX
  package's bytes for the same inputs and seed.
- Both readers yield every batch bit-equal to JAX's
  ``BinaryCriteoReader``: whole batches, the data-parallel window
  (``offset`` / ``lbs``), the model-parallel table selection, the test
  split, ``drop_last_batch``, random access, no streams; a short stream
  refuses, and an index past the end raises ``IndexError``.
- ``open_raw_binary_dataset`` picks and names its reader; the host
  library is built under a name keyed by its source hash.
- The Python reader's ``pread`` retry (JAX's
  tests/test_fault_tolerance.py cases): two transient failures are
  retried with the batches unchanged, a persistent one raises.
"""

import importlib.util
import os
import pathlib
import sys

import numpy as np
import pytest

from distributed_embeddings_tpu.utils import data as jax_data
from distributed_embeddings_tpu.utils import faultinject
from distributed_embeddings_tpu_torch.examples.dlrm import gen_data
from distributed_embeddings_tpu_torch.utils import data
from distributed_embeddings_tpu_torch.utils import fastloader
from distributed_embeddings_tpu_torch.utils import nativebuild
from distributed_embeddings_tpu_torch.utils import resilience

SIZES = [100, 40000, 3, 100000]  # int8, int16, int8, int32 files
N_ROWS = 333
BATCH = 64  # 333 = 5 * 64 + 13: a short final batch
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _write(write_fn, root, seed=0):
  rng = np.random.default_rng(seed)
  for split, n in (('train', N_ROWS), ('test', 130)):
    labels = rng.integers(0, 2, size=(n,)).astype(bool)
    numerical = rng.normal(size=(n, 13)).astype(np.float16)
    cats = [rng.integers(0, s, size=(n,)) for s in SIZES]
    write_fn(str(root), split, labels, numerical, cats, SIZES)


def _files(root):
  root = pathlib.Path(root)
  return {str(p.relative_to(root)): p.read_bytes()
          for p in sorted(root.rglob('*')) if p.is_file()}


@pytest.fixture(scope='module')
def dataset_dir(tmp_path_factory):
  root = tmp_path_factory.mktemp('port_raw_binary')
  _write(data.write_raw_binary_dataset, root)
  return str(root)


def test_writer_bytes_equal_jax(tmp_path, dataset_dir):
  _write(jax_data.write_raw_binary_dataset, tmp_path / 'jax')
  got, want = _files(dataset_dir), _files(tmp_path / 'jax')
  assert sorted(got) == sorted(want) and len(got) == 2 * (2 + len(SIZES))
  for name in want:
    assert got[name] == want[name], name


def test_gen_data_bytes_equal_jax(tmp_path, monkeypatch):
  flags = ['--preset', 'onechip', '--scale', '5000', '--train_rows',
           '3000', '--eval_rows', '700', '--seed', '3']
  gen_data.main(['--data_path', str(tmp_path / 'port')] + flags)
  spec = importlib.util.spec_from_file_location(
      'jax_gen_data', ROOT / 'examples' / 'dlrm' / 'gen_data.py')
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  monkeypatch.setattr(sys, 'argv', ['gen_data.py', '--data_path',
                                    str(tmp_path / 'jax')] + flags)
  mod.main()
  got, want = _files(tmp_path / 'port'), _files(tmp_path / 'jax')
  assert sorted(got) == sorted(want) and 'model_size.json' in got
  for name in want:
    assert got[name] == want[name], name


def test_gen_data_chunks_append_like_one_write(tmp_path):
  """More rows than one chunk of ``generate_split``: the appended files
  read back as one split of the right size."""
  sizes = [50, 7]
  gen_data.write_dataset(str(tmp_path), sizes, (1 << 20) + 5, 3,
                         num_numerical=2)
  r = data.BinaryCriteoReader(str(tmp_path), batch_size=1 << 19,
                              numerical_features=2,
                              categorical_features=[0, 1],
                              categorical_feature_sizes=sizes,
                              prefetch_depth=0)
  assert len(r) == 3
  num, cats, labels = r[2]
  assert num.shape == (5, 2) and cats[0].shape == (5,) and labels.shape == (
      5, 1)
  assert cats[0].max() < 50 and cats[1].max() < 7
  r.close()


def _kwargs(**over):
  kw = dict(batch_size=BATCH, numerical_features=13,
            categorical_features=[0, 1, 2, 3],
            categorical_feature_sizes=SIZES, prefetch_depth=4)
  kw.update(over)
  return kw


MODES = {
    'plain': {},
    'dp_window': dict(offset=16, lbs=16, dp_input=True),
    'mp_window': dict(offset=32, lbs=16, dp_input=False),
    'mp_tables': dict(categorical_features=[3, 1]),
    'valid': dict(valid=True, offset=16, lbs=16, dp_input=True),
    'drop_last': dict(drop_last_batch=True),
    'no_streams': dict(numerical_features=0, categorical_features=[],
                       categorical_feature_sizes=[]),
}


def _assert_batches_equal(got, want):
  gn, gc, gl = got
  wn, wc, wl = want
  np.testing.assert_array_equal(gl, wl)
  assert gl.dtype == wl.dtype
  if wn is None:
    assert gn is None or gn.size == 0
  else:
    np.testing.assert_array_equal(gn, wn)
    assert gn.dtype == wn.dtype
  if wc is None:
    assert not gc
  else:
    assert len(gc) == len(wc)
    for g, w in zip(gc, wc):
      np.testing.assert_array_equal(g, w)
      assert g.dtype == w.dtype


def _readers(kind, root, **kw):
  if kind == 'python':
    return data.BinaryCriteoReader(root, **kw)
  return fastloader.FastBinaryCriteoReader(root, **kw)


@pytest.mark.parametrize('mode', sorted(MODES))
@pytest.mark.parametrize('kind', ['python', 'native'])
def test_reader_batches_equal_jax(dataset_dir, kind, mode):
  want = jax_data.BinaryCriteoReader(dataset_dir, **_kwargs(**MODES[mode]))
  got = _readers(kind, dataset_dir, **_kwargs(**MODES[mode]))
  assert len(got) == len(want)
  for i in range(len(want)):
    _assert_batches_equal(got[i], want[i])
  assert [b[2].shape for b in got] == [b[2].shape for b in want]
  got.close()
  want.close()


@pytest.mark.parametrize('kind', ['python', 'native'])
def test_reader_random_access(dataset_dir, kind):
  want = jax_data.BinaryCriteoReader(dataset_dir, **_kwargs(prefetch_depth=1))
  got = _readers(kind, dataset_dir, **_kwargs())
  for i in [3, 0, 5, 2, 2]:
    _assert_batches_equal(got[i], want[i])
  got.close()


@pytest.mark.parametrize('kind', ['python', 'native'])
def test_reader_index_error(dataset_dir, kind):
  got = _readers(kind, dataset_dir, **_kwargs())
  with pytest.raises(IndexError):
    got[len(got)]
  got.close()


def test_reader_size_mismatch_refuses(tmp_path):
  _write(data.write_raw_binary_dataset, tmp_path)
  with open(tmp_path / 'train' / 'cat_0.bin', 'r+b') as f:
    f.truncate(10)
  with pytest.raises(ValueError, match='label.bin implies') as got:
    data.BinaryCriteoReader(str(tmp_path), **_kwargs())
  with pytest.raises(ValueError) as want:
    jax_data.BinaryCriteoReader(str(tmp_path), **_kwargs())
  assert str(got.value) == str(want.value)


def test_open_raw_binary_dataset_names_its_reader(dataset_dir):
  native = fastloader.open_raw_binary_dataset(dataset_dir, **_kwargs())
  assert fastloader.reader_kind(native) == 'native'
  python = fastloader.open_raw_binary_dataset(dataset_dir, native='never',
                                              **_kwargs())
  assert fastloader.reader_kind(python) == 'python'
  assert fastloader.reader_kind(fastloader.open_raw_binary_dataset(
      dataset_dir, native='require', **_kwargs())) == 'native'
  _assert_batches_equal(native[0], python[0])
  with pytest.raises(ValueError, match='unknown native mode'):
    fastloader.open_raw_binary_dataset(dataset_dir, native='maybe')
  native.close()
  python.close()


def test_host_library_is_keyed_by_its_source():
  built = nativebuild.build_host('fastloader')
  assert built.path == nativebuild.host_library_path('fastloader')
  assert built.path.exists() and built.path.parent == nativebuild.BUILD_DIR
  assert 'fastloader-host-' in built.path.name
  assert nativebuild.build_host('fastloader').seconds == 0.0  # up to date
  assert os.path.dirname(str(nativebuild.HOST_DIR / 'fastloader.cc')) == str(
      nativebuild.CSRC_DIR / 'host')


def test_smallest_int_dtype_like_jax():
  for n in (3, 126, 127, 128, 32766, 32767, 40000, 2**31 - 2):
    assert data.smallest_int_dtype(n) == jax_data.smallest_int_dtype(n)
  with pytest.raises(RuntimeError):
    data.smallest_int_dtype(2**31)


# ------------------------------------------ the example's dataset flags

SMALL = ['--device', 'cpu', '--batch_size', '64', '--embedding_dim', '8',
         '--bottom_mlp_dims', '16,8', '--top_mlp_dims', '16,1']


@pytest.fixture(scope='module')
def criteo_dir(tmp_path_factory):
  root = tmp_path_factory.mktemp('criteo_small')
  gen_data.main(['--data_path', str(root), '--preset', 'onechip', '--scale',
                 '20000', '--train_rows', '1024', '--eval_rows', '256'])
  return str(root)


def test_entry_point_reads_the_dataset(criteo_dir, capsys):
  """``--dataset_path``: table sizes from ``model_size.json``, batches
  from the native reader (named), ``--loader_bench`` timing it first."""
  import json as json_lib
  from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
  out = dlrm_main.main(SMALL + ['--dataset_path', criteo_dir, '--max_steps',
                                '3', '--loader_bench', '--eval',
                                '--eval_batches', '2'])
  text = capsys.readouterr().out
  assert 'dataset: ' in text and 'native reader' in text
  assert out['loader'] == 'native' and out['loader_samples_per_s'] > 0
  assert 'loader: 1024 samples in ' in text
  assert out['step'] == 3 and np.isfinite(out['loss'])
  with open(os.path.join(criteo_dir, 'model_size.json')) as f:
    sizes = [s + 1 for s in json_lib.load(f).values()]
  assert 0.0 < out['auc'][-1][1] < 1.0 and len(sizes) == 26


def _state_arrays(path):
  with np.load(path) as z:
    return {k: z[k] for k in z.files if not k.startswith('__')}


def test_entry_point_cold_tier_equals_resident(criteo_dir, tmp_path, capsys):
  """``--cold_tier_budget_mb``: the tiered run (its tails in host memory,
  the pre-pass pipelined) saves the same state bit for bit as the run
  without the tier, and prints the tier's geometry and overlap."""
  from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
  flags = SMALL + ['--dataset_path', criteo_dir, '--dp_input', '--hot_cache',
                   '--max_steps', '4']
  dlrm_main.main(flags + ['--save_state', str(tmp_path / 'resident.npz')])
  out = dlrm_main.main(flags + ['--cold_tier_budget_mb', '0.02',
                                '--save_state', str(tmp_path / 'tier.npz')])
  text = capsys.readouterr().out
  assert 'cold_tier: 1 tiered group(s)' in text
  assert 'sized on 1 batch(es) held out of the hot-set calibration' in text
  assert len(out['tier_prepass_ms']) == len(out['tier_blocked_ms']) == 4
  assert '% of the host pre-pass hidden' in text
  assert len(out['tier_losses']) == 4 and np.isfinite(out['tier_losses']).all()
  assert 0.0 <= out['tier_pipeline']['overlap_pct'] <= 1.0
  a = _state_arrays(tmp_path / 'resident.npz')
  b = _state_arrays(tmp_path / 'tier.npz')
  assert sorted(a) == sorted(b)
  for k in a:
    np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize('flags', [
    ['--cold_tier_budget_mb', '64'],
    ['--cold_tier_budget_mb', '64', '--dp_input', '--hot_cache', '--trainer',
     'dense']], ids=['dp_input', 'dense'])
def test_entry_point_tier_refusals_match_jax(flags):
  from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
  from examples.dlrm import main as jax_main
  jax_flags = [f for f in SMALL if f not in ('--device', 'cpu')]
  argv, sys.argv = sys.argv, ['main.py'] + jax_flags + flags
  try:
    with pytest.raises(SystemExit) as want:
      jax_main.main()
  finally:
    sys.argv = argv
  with pytest.raises(SystemExit) as got:
    dlrm_main.main(SMALL + flags)
  assert str(got.value) == str(want.value)
  assert '--cold_tier_budget_mb requires' in str(got.value)


def _tiny_split(root):
  """JAX's ``_write_tiny_dataset``: 32 rows, 3 numerical features, two
  tables of 50 and 70 rows; reader kwargs without read-ahead."""
  rng = np.random.default_rng(0)
  rows, sizes = 32, [50, 70]
  labels = rng.integers(0, 2, rows).astype(bool)
  numerical = rng.normal(size=(rows, 3)).astype(np.float16)
  cats = [rng.integers(0, s, rows) for s in sizes]
  data.write_raw_binary_dataset(str(root), 'train', labels, numerical, cats,
                                sizes)
  return dict(batch_size=8, numerical_features=3, categorical_features=[0, 1],
              categorical_feature_sizes=sizes, prefetch_depth=0)


def test_reader_transient_pread_recovers_zero_loss(tmp_path, monkeypatch):
  kwargs = _tiny_split(tmp_path)
  want = [(n.copy(), [c.copy() for c in cs], l.copy())
          for n, cs, l in data.BinaryCriteoReader(str(tmp_path), **kwargs)]
  resilience.clear_recent()
  flaky = faultinject.flaky_calls(os.pread, fail_at=[1, 6], times=1)
  monkeypatch.setattr(os, 'pread', flaky)
  got = list(data.BinaryCriteoReader(str(tmp_path), **kwargs))
  monkeypatch.undo()
  assert flaky.raised == 2
  assert len(got) == len(want) == 4
  for g, w in zip(got, want):
    _assert_batches_equal(g, w)
  assert len(resilience.recent('io_retry')) == 2


def test_reader_persistent_io_error_still_raises(tmp_path, monkeypatch):
  kwargs = _tiny_split(tmp_path)
  reader = data.BinaryCriteoReader(str(tmp_path), **kwargs)
  resilience.clear_recent()
  # the first pread fails more times than the retry budget allows
  flaky = faultinject.flaky_calls(os.pread, fail_at=[0], times=10)
  monkeypatch.setattr(os, 'pread', flaky)
  with pytest.raises(IOError):
    reader[0]
  assert resilience.recent('io_retry_exhausted')
