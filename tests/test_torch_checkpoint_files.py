"""The port's checkpoint files against the JAX package's, on the CPU.

- Interchange: the same train state held by both packages (a hybrid
  ``SparseAdagrad`` state with f32 and with bf16 tables and
  accumulators, a hybrid ``SparseSGD`` state with scheduled SGD, and the
  dense ``make_train_step`` state with scheduled SGD and with Adagrad,
  f32 and bf16), saved by each package's ``CheckpointCallback``, gives
  equal manifests array by array (key, dtype, shape, sha256); a JAX file
  restores into the port and a port file into JAX, bit for bit.  The
  dense params carry an MLP subtree, so the ``nn.Linear`` transposes of
  the key map are held too.
- Failures, as the port's cases of tests/test_fault_tolerance.py:
  truncate and byte-flip fall-back, plan mismatch, legacy file,
  atomic save under a mid-write failure, quarantine, prune anchored to
  the newest verified file, in-flight targets, the numeric tie-break,
  the ``save_npz`` interchange format and the ``verify_checkpoint``
  CLI.
- Resharding: a file written at world 1 restores into a world-2 model
  (two gloo ranks) and a world-2 file into world 1; there, the
  auditor's replica digest finds a dense copy that diverged on one rank.
"""

import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import callbacks as jax_callbacks
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import grad as jax_grad
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.utils import faultinject
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.parallel import audit
from distributed_embeddings_tpu_torch.parallel import callbacks
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import grad
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.tools import verify_checkpoint
from distributed_embeddings_tpu_torch.utils import resilience

import torch_parity

torch.set_num_threads(1)

SPECS = torch_parity.MIXED_SPECS
STEP = 7
# the dense params: a linear kernel and a two-layer MLP, in the JAX
# package's layout ([in, out] kernels)
DENSE_SHAPES = {'kernel': (6, 1),
                'mlp': [{'kernel': (6, 5), 'bias': (5,)},
                        {'kernel': (5, 1), 'bias': (1,)}]}


@pytest.fixture(autouse=True)
def _journal_to_tmp(tmp_path, monkeypatch):
  monkeypatch.setenv('DET_FT_JOURNAL', str(tmp_path / 'ft_journal.jsonl'))
  resilience.clear_recent()


def _layers(param_dtype):
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(r, w, combiner=c) for r, w, c, _ in SPECS],
      mesh=torch_parity.jax_mesh(1), packed_storage=False,
      strategy='memory_balanced',
      param_dtype=jnp.bfloat16 if param_dtype == 'bfloat16' else jnp.float32)
  pd = DistributedEmbedding(
      [TableConfig(r, w, combiner=c) for r, w, c, _ in SPECS],
      device='cpu', strategy='memory_balanced',
      param_dtype=getattr(torch, param_dtype))
  return jd, pd


def _round(a, dtype):
  """``a`` rounded to ``dtype`` (bf16 values held in f32)."""
  if dtype == 'bfloat16':
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
  return np.asarray(a, np.float32)


def _tree(shapes, rng, dtype, positive=False):
  if isinstance(shapes, dict):
    return {k: _tree(v, rng, dtype, positive) for k, v in shapes.items()}
  if isinstance(shapes, list):
    return [_tree(v, rng, dtype, positive) for v in shapes]
  a = rng.normal(size=shapes)
  return _round(np.abs(a) + 0.1 if positive else a, dtype)


def _port_dense(jtree):
  """The JAX dense tree in the port's layout: ``'mlp.layers.i.weight'``
  ``[out, in]``."""
  out = {'kernel': torch.tensor(jtree['kernel'])}
  for i, layer in enumerate(jtree['mlp']):
    out[f'mlp.layers.{i}.weight'] = torch.tensor(layer['kernel'].T.copy())
    out[f'mlp.layers.{i}.bias'] = torch.tensor(layer['bias'])
  return out


def _cast(tree, dtype):
  if isinstance(tree, dict):
    return {k: _cast(v, dtype) for k, v in tree.items()}
  if isinstance(tree, list):
    return [_cast(v, dtype) for v in tree]
  if isinstance(tree, torch.Tensor):
    return tree.to(getattr(torch, dtype))
  return jnp.asarray(tree, jnp.bfloat16 if dtype == 'bfloat16'
                     else jnp.float32)


CASES = {
    # (trainer, dense optimizer, dtype)
    'hybrid-adagrad-f32': ('hybrid', 'adagrad', 'float32'),
    'hybrid-adagrad-bf16': ('hybrid', 'adagrad', 'bfloat16'),
    'hybrid-sgd-f32': ('hybrid', 'sgd', 'float32'),
    'dense-sgd-f32': ('dense', 'sgd', 'float32'),
    'dense-adagrad-f32': ('dense', 'adagrad', 'float32'),
    'dense-adagrad-bf16': ('dense', 'adagrad', 'bfloat16'),
}


def _states(case, seed=0):
  """One train state in both packages, from the same numpy draws:
  ``(jd, jstate, pd, pstate, fresh_jax, fresh_port)``; the ``fresh_*``
  callables build templates of the same structure with other values."""
  trainer, opt, dtype = CASES[case]
  jd, pd = _layers(dtype)
  rng = np.random.default_rng(seed)
  tables = [_round(rng.normal(size=(r, w)), dtype) for r, w, _, _ in SPECS]
  dense = _tree(DENSE_SHAPES, rng, dtype)
  sched = lambda c: 0.1 / (1 + c)
  jopt, popt = {'sgd': (optax.sgd(sched), optim.sgd(sched)),
                'adagrad': (optax.adagrad(0.1), optim.adagrad(0.1))}[opt]
  sos = _tree(DENSE_SHAPES, rng, dtype, positive=True)
  emb_sos = [_round(np.abs(rng.normal(size=(r, w))) + 0.1, dtype)
             for r, w, _, _ in SPECS]
  accs = [{'acc': _round(np.abs(rng.normal(size=(r, w))) + 0.1, dtype)}
          for r, w, _, _ in SPECS]

  def jax_opt_state(params, with_emb):
    st = jopt.init(params)
    if opt == 'sgd':
      return (st[0], st[1]._replace(count=jnp.asarray(STEP, jnp.int32)))
    tree = _cast(sos, dtype)
    if with_emb:
      tree['embedding'] = jax_ckpt.set_weights(jd, emb_sos)
    return (st[0]._replace(sum_of_squares=tree), st[1])

  def port_opt_state(params, with_emb):
    if opt == 'sgd':
      return {'count': STEP}
    tree = _cast(_port_dense(sos), dtype)
    if with_emb:
      tree['embedding'] = checkpoint.set_weights(pd, emb_sos)
    return {'sum_of_squares': tree}

  jparams = {'embedding': jax_ckpt.set_weights(jd, tables),
             **_cast(dense, dtype)}
  pparams = {'embedding': checkpoint.set_weights(pd, tables),
             **_cast(_port_dense(dense), dtype)}
  if trainer == 'hybrid':
    jemb = jax_sparse.SparseAdagrad(
        0.1, accum_dtype=dtype) if opt == 'adagrad' else \
        jax_sparse.SparseSGD(0.1)
    pemb = sparse.SparseAdagrad(
        0.1, accum_dtype=dtype) if opt == 'adagrad' else \
        sparse.SparseSGD(0.1)
    jstate = jax_sparse.init_hybrid_train_state(jd, jparams, jopt, jemb)
    emb_state = jstate.opt_state[1]
    if opt == 'adagrad':
      emb_state = jax_ckpt.set_optimizer_state(jd, emb_state, accs)
    dense_only = {k: v for k, v in jparams.items() if k != 'embedding'}
    jstate = jstate._replace(
        opt_state=(jax_opt_state(dense_only, False), emb_state),
        step=jnp.asarray(STEP, jnp.int32))
    pstate = sparse.init_hybrid_train_state(pd, pparams, popt, pemb)
    if opt == 'adagrad':
      checkpoint.set_optimizer_state(pd, pstate.opt_state[1], accs)
    pstate = pstate._replace(opt_state=(port_opt_state(None, False),
                                        pstate.opt_state[1]), step=STEP)

    def fresh_jax():
      p = {'embedding': jd.init(1), **jax.tree.map(jnp.zeros_like,
                                                   _cast(dense, dtype))}
      return jax_sparse.init_hybrid_train_state(jd, p, jopt, jemb)

    def fresh_port():
      p = {'embedding': pd.init(1),
           **{k: torch.zeros_like(v) for k, v in pparams.items()
              if k != 'embedding'}}
      return sparse.init_hybrid_train_state(pd, p, popt, pemb)
  else:
    jstate = jax_grad.TrainState(jparams, jax_opt_state(jparams, True),
                                 jnp.asarray(STEP, jnp.int32))
    pstate = grad.TrainState(pparams, port_opt_state(pparams, True), STEP)

    def fresh_jax():
      p = {'embedding': jd.init(1), **jax.tree.map(jnp.zeros_like,
                                                   _cast(dense, dtype))}
      return jax_grad.init_train_state(p, jopt)

    def fresh_port():
      p = {'embedding': pd.init(1),
           **{k: torch.zeros_like(v) for k, v in pparams.items()
              if k != 'embedding'}}
      return grad.init_train_state(p, popt)
  return jd, jstate, pd, pstate, fresh_jax, fresh_port


def _f32(x):
  if isinstance(x, torch.Tensor):
    return x.detach().float().numpy()
  return np.asarray(x, np.float32)


def _port_leaves(pd, state):
  """Every leaf of a port state, the tables and sparse state in the
  global layout (padding rows excluded), the rest as they are."""
  out = [_f32(t) for t in checkpoint.get_weights(pd, state.params[
      'embedding'])]
  out += [_f32(v) for k, v in sorted(state.params.items())
          if k != 'embedding']
  if checkpoint.is_hybrid_opt_state(pd, state.opt_state):
    dense_opt = state.opt_state[0]
    for entry in checkpoint.get_optimizer_state(pd, state.opt_state[1]):
      out += [_f32(entry[k]) for k in sorted(entry)]
  else:
    dense_opt = state.opt_state
  out += [np.asarray(leaf, np.float32) if isinstance(leaf, int)
          else _f32(leaf)
          for _, leaf, _ in checkpoint._flatten(dense_opt, opt=True)]
  return out + [np.float32(int(state.step))]


def _jax_leaves(jd, state):
  out = [_f32(t) for t in jax_ckpt.get_weights(jd, state.params[
      'embedding'])]
  dense = {k: v for k, v in state.params.items() if k != 'embedding'}
  out += [_f32(v) for v in jax.tree_util.tree_leaves(dense)]
  if jax_ckpt.is_hybrid_opt_state(jd, state.opt_state):
    dense_opt = state.opt_state[0]
    for entry in jax_ckpt.get_optimizer_state(jd, state.opt_state[1]):
      out += [_f32(entry[k]) for k in sorted(entry)]
  else:
    dense_opt = state.opt_state
  out += [_f32(v)[0] if v.ndim == 3 else _f32(v)
          for v in jax.tree_util.tree_leaves(dense_opt)]
  return out + [np.float32(int(state.step))]


def _save_both(jd, jstate, pd, pstate, tmp_path):
  jpath, ppath = str(tmp_path / 'jax.npz'), str(tmp_path / 'port.npz')
  jax_callbacks.CheckpointCallback(jd, jpath, every=1)(STEP, jstate, {})
  callbacks.CheckpointCallback(pd, ppath, every=1)(STEP, pstate, {})
  return jpath, ppath


@pytest.mark.parametrize('case', sorted(CASES))
def test_manifests_equal_array_by_array(case, tmp_path):
  jd, jstate, pd, pstate, _, _ = _states(case)
  jpath, ppath = _save_both(jd, jstate, pd, pstate, tmp_path)
  jman, pman = checkpoint.read_manifest(jpath), jax_ckpt.read_manifest(ppath)
  assert (pman['step'], pman['plan']) == (jman['step'], jman['plan']) == (
      STEP, checkpoint.plan_fingerprint(pd))
  assert list(pman['arrays']) == list(jman['arrays'])
  for key, meta in jman['arrays'].items():
    assert pman['arrays'][key] == meta, key
  # the member bytes agree too: each file verifies under both packages
  assert checkpoint.verify_npz(jpath, expect_plan=pd)[0]
  assert jax_ckpt.verify_npz(ppath, expect_plan=jd)[0]


@pytest.mark.parametrize('case', sorted(CASES))
def test_files_restore_across_packages_bit_exact(case, tmp_path):
  jd, jstate, pd, pstate, fresh_jax, fresh_port = _states(case)
  jpath, ppath = _save_both(jd, jstate, pd, pstate, tmp_path)
  want = _port_leaves(pd, pstate)
  restored, path = checkpoint.restore_train_state(pd, fresh_port(), jpath)
  assert path == jpath and restored.step == STEP
  got = _port_leaves(pd, restored)
  assert len(got) == len(want)
  for i, (g, w) in enumerate(zip(got, want)):
    np.testing.assert_array_equal(g, w, err_msg=f'port leaf {i}')
  # the restore wrote into the template's tensors, at their dtype
  for k, v in restored.params.items():
    if k != 'embedding':
      assert v.dtype == pstate.params[k].dtype
  jrestored, _ = jax_ckpt.restore_train_state(jd, fresh_jax(), ppath)
  want = _jax_leaves(jd, jstate)
  got = _jax_leaves(jd, jrestored)
  assert len(got) == len(want)
  for i, (g, w) in enumerate(zip(got, want)):
    np.testing.assert_array_equal(g, w, err_msg=f'jax leaf {i}')


def test_bf16_is_the_only_widened_dtype(tmp_path):
  """bf16 tensors are stored as f32 (exact); an int32 count, an int64
  step and Adam's per-row int32 ``t`` keep their dtypes."""
  t = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
  assert checkpoint._portable(t).dtype == np.float32
  np.testing.assert_array_equal(checkpoint._portable(t), [1.5, -2.25, 3.0])
  path = str(tmp_path / 'x.npz')
  checkpoint.save_train_npz(
      path, [np.ones((3, 2), np.float32)],
      [{'t': torch.tensor([0, 3, 9], dtype=torch.int32), 'acc': t}],
      extras={'step': np.int64(4), 'opt:[1].count': np.int32(4)})
  arrays = checkpoint.read_manifest(path)['arrays']
  assert arrays['table0/t']['dtype'] == '<i4'
  assert arrays['table0/acc']['dtype'] == '<f4'
  assert arrays['extra/step']['dtype'] == '<i8'
  assert arrays['extra/opt:[1].count']['dtype'] == '<i4'


# --------------------------------------------------------------------------
# failures: the port's cases of tests/test_fault_tolerance.py
# --------------------------------------------------------------------------

CONFIGS = [TableConfig(40, 8, combiner='sum'),
           TableConfig(30, 8, combiner='mean')]


@pytest.fixture(scope='module')
def dist():
  return DistributedEmbedding(CONFIGS, device='cpu')


def _weights(seed):
  rng = np.random.default_rng(seed)
  return [rng.normal(size=(c.input_dim, c.output_dim)).astype(np.float32)
          for c in CONFIGS]


def _save_steps(dist, tmp_path, weights, steps=(10, 20, 30)):
  st = [{'acc': np.full((c.input_dim, c.output_dim), 0.1, np.float32)}
        for c in CONFIGS]
  paths = []
  for step_no in steps:
    p = str(tmp_path / f'ckpt_{step_no}.npz')
    checkpoint.save_train_npz(p, weights, st,
                              extras={'step': np.int64(step_no)}, plan=dist)
    os.utime(p, (step_no, step_no))
    paths.append(p)
  return paths


def test_corruption_truncate_and_flip_fall_back(dist, tmp_path):
  weights = _weights(1)
  p10, p20, p30 = _save_steps(dist, tmp_path, weights)
  man = checkpoint.read_manifest(p10)
  assert man['step'] == 10 and man['plan'] == checkpoint.plan_fingerprint(
      dist)
  faultinject.truncate_file(p30, nbytes=512)
  faultinject.flip_bytes(p20, count=8, seed=0)
  path, (w, _, extras) = checkpoint.load_latest_valid(str(tmp_path),
                                                      expect_plan=dist)
  assert path == p10 and int(extras['step']) == 10
  for a, b in zip(weights, w):
    np.testing.assert_array_equal(a, b)
  rejected = resilience.recent('checkpoint_rejected')
  assert {os.path.basename(e['path']) for e in rejected} == {
      'ckpt_20.npz', 'ckpt_30.npz'}
  assert all(e['reason'] for e in rejected)


@pytest.mark.parametrize('quarantine', [False, True])
def test_plan_mismatch_rejected_never_quarantined(dist, tmp_path,
                                                  quarantine):
  p = str(tmp_path / 'ckpt_5.npz')
  checkpoint.save_train_npz(p, _weights(2), extras={'step': np.int64(5)},
                            plan=dist)
  other = [TableConfig(41, 8, 'sum'), TableConfig(30, 8, 'mean')]
  ok, reason, _ = checkpoint.verify_npz(p, expect_plan=other)
  assert not ok and 'plan-mismatch' in reason
  assert checkpoint.plan_fingerprint(dist) != checkpoint.plan_fingerprint(
      other)
  with pytest.raises(FileNotFoundError, match='plan-mismatch'):
    checkpoint.load_latest_valid(str(tmp_path), expect_plan=other,
                                 quarantine=quarantine)
  assert os.path.exists(p)
  assert not resilience.recent('checkpoint_quarantined')


def test_legacy_manifestless_npz_still_loads(tmp_path):
  rng = np.random.default_rng(3)
  weights = {f'table{i}': rng.normal(size=(c.input_dim, c.output_dim)
                                     ).astype(np.float32)
             for i, c in enumerate(CONFIGS)}
  legacy = str(tmp_path / 'legacy.npz')
  np.savez(legacy, **weights)
  ok, reason, man = checkpoint.verify_npz(legacy)
  assert ok and reason == 'legacy-no-manifest' and man is None
  path, (w, _, _) = checkpoint.load_latest_valid(str(tmp_path))
  assert path == legacy
  np.testing.assert_array_equal(w[0], weights['table0'])


def test_atomic_save_survives_midwrite_failure(dist, tmp_path, monkeypatch):
  weights = _weights(4)
  p = str(tmp_path / 'state.npz')
  checkpoint.save_train_npz(p, weights, extras={'step': np.int64(1)},
                            plan=dist)

  def dying_savez(f, **payload):
    f.write(b'partial garbage the crash leaves behind')
    raise IOError('injected mid-write crash')

  monkeypatch.setattr(np, 'savez', dying_savez)
  with pytest.raises(IOError, match='mid-write'):
    checkpoint.save_train_npz(p, weights, extras={'step': np.int64(2)},
                              plan=dist)
  monkeypatch.undo()
  ok, reason, man = checkpoint.verify_npz(p, expect_plan=dist)
  assert ok, reason
  assert man['step'] == 1
  assert not [f for f in os.listdir(tmp_path) if '.tmp' in f]


def test_quarantine_renames_and_excludes(dist, tmp_path):
  p10, p20, p30 = _save_steps(dist, tmp_path, _weights(11))
  faultinject.flip_bytes(p30, count=8, seed=0)
  faultinject.truncate_file(p20, nbytes=512)
  path, (_, _, extras) = checkpoint.load_latest_valid(
      str(tmp_path), expect_plan=dist, quarantine=True)
  assert path == p10 and int(extras['step']) == 10
  names = sorted(os.listdir(tmp_path))
  assert 'ckpt_30.npz.corrupt' in names and 'ckpt_20.npz.corrupt' in names
  assert 'ckpt_30.npz' not in names
  q = resilience.recent('checkpoint_quarantined')
  assert {os.path.basename(e['path']) for e in q} == {'ckpt_20.npz',
                                                      'ckpt_30.npz'}
  path2, _ = checkpoint.load_latest_valid(str(tmp_path), expect_plan=dist)
  assert path2 == p10
  assert checkpoint.prune_checkpoints(str(tmp_path), keep_last=1) == []
  assert 'ckpt_30.npz.corrupt' in os.listdir(tmp_path)
  # a second quarantine of the same name takes the next suffix
  checkpoint.save_train_npz(p30, _weights(11), extras={'step': np.int64(30)})
  assert checkpoint.quarantine_checkpoint(p30).endswith('.corrupt.2')


def test_prune_anchors_to_newest_verified(dist, tmp_path):
  paths = _save_steps(dist, tmp_path, _weights(13), steps=(10, 20, 30, 40))
  faultinject.flip_bytes(paths[2], count=8, seed=1)
  faultinject.flip_bytes(paths[3], count=8, seed=2)
  removed = checkpoint.prune_checkpoints(str(tmp_path), keep_last=2)
  assert [os.path.basename(r) for r in removed] == ['ckpt_10.npz']
  assert os.path.exists(paths[1])


def test_prune_spares_in_flight_rollback_target(dist, tmp_path):
  p10, _, _ = _save_steps(dist, tmp_path, _weights(14))
  with checkpoint._protect_path(p10):
    removed = checkpoint.prune_checkpoints(str(tmp_path), keep_last=1)
    assert [os.path.basename(r) for r in removed] == ['ckpt_20.npz']
    assert os.path.exists(p10)
  removed = checkpoint.prune_checkpoints(str(tmp_path), keep_last=1)
  assert [os.path.basename(r) for r in removed] == ['ckpt_10.npz']
  with pytest.raises(ValueError, match='keep_last'):
    checkpoint.prune_checkpoints(str(tmp_path), keep_last=0)


def test_latest_valid_numeric_tiebreak_on_equal_mtime(dist, tmp_path):
  weights = _weights(6)
  for step_no in (999, 1000):
    p = str(tmp_path / f'ckpt_{step_no}.npz')
    checkpoint.save_train_npz(p, weights, extras={'step': np.int64(step_no)},
                              plan=dist)
    os.utime(p, (1000, 1000))
  path, (_, _, extras) = checkpoint.load_latest_valid(str(tmp_path),
                                                      expect_plan=dist)
  assert path.endswith('ckpt_1000.npz') and int(extras['step']) == 1000
  removed = checkpoint.prune_checkpoints(str(tmp_path), keep_last=1)
  assert [os.path.basename(r) for r in removed] == ['ckpt_999.npz']


def test_corrupt_substring_mid_name_stays_visible(dist, tmp_path):
  odd = str(tmp_path / 'sdc.corrupt_drill_10.npz')
  checkpoint.save_train_npz(odd, _weights(31), extras={'step': np.int64(10)},
                            plan=dist)
  path, _ = checkpoint.load_latest_valid(str(tmp_path), expect_plan=dist)
  assert path == odd
  assert checkpoint._is_quarantined('x.npz.corrupt')
  assert checkpoint._is_quarantined('x.npz.corrupt.3')
  assert not checkpoint._is_quarantined('sdc.corrupt_drill_10.npz')


def test_save_npz_keeps_reference_interchange_format(tmp_path):
  w = [torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
       np.ones((3, 3), np.float32)]
  p = str(tmp_path / 'w.npz')
  checkpoint.save_npz(p, w)
  with np.load(p) as data:
    assert sorted(data.files) == ['arr_0', 'arr_1']
  for a, b in zip(w, checkpoint.load_npz(p)):
    np.testing.assert_array_equal(np.asarray(a, np.float32)
                                  if not isinstance(a, torch.Tensor)
                                  else a.float().numpy(), b)
  # and the JAX package reads it positionally
  for a, b in zip(checkpoint.load_npz(p), jax_ckpt.load_npz(p)):
    np.testing.assert_array_equal(a, b)
  ok, reason, _ = checkpoint.verify_npz(p)
  assert ok and reason == 'legacy-no-manifest'
  assert not [f for f in os.listdir(tmp_path) if '.tmp' in f]


def test_verify_checkpoint_cli(dist, tmp_path, capsys):
  """Per-file verdicts; quarantined files informational; exit 1 on any
  failure, 0 on a healthy walk; a quantized file off the row contract
  (a scale that is no power of two) fails with the reason."""
  weights = _weights(21)
  good = str(tmp_path / 'good_10.npz')
  checkpoint.save_train_npz(good, weights, extras={'step': np.int64(10)},
                            plan=dist)
  flipped = str(tmp_path / 'flipped_40.npz')
  checkpoint.save_train_npz(flipped, weights,
                            extras={'step': np.int64(40)}, plan=dist)
  faultinject.flip_bytes(flipped, count=8, seed=3)
  legacy = str(tmp_path / 'legacy_2.npz')
  checkpoint.save_npz(legacy, weights)
  quant = str(tmp_path / 'quant_20.npz')
  np.savez(quant, **{'table0': np.zeros((4, 2), np.int8),
                     'table0:scale': np.array([1, 1, 0.3, 1], np.float32)})
  old = str(tmp_path / 'old_5.npz')
  checkpoint.save_train_npz(old, weights, extras={'step': np.int64(5)},
                            plan=dist)
  checkpoint.quarantine_checkpoint(old)
  rc = verify_checkpoint.main([str(tmp_path)])
  out = capsys.readouterr().out
  assert rc == 1
  lines = {l.split()[0]: l for l in out.strip().splitlines() if l.strip()}
  assert 'OK' in lines['good_10.npz'] and 'step 10' in lines['good_10.npz']
  assert 'FAIL' in lines['flipped_40.npz']
  assert 'LEGACY' in lines['legacy_2.npz']
  assert 'FAIL' in lines['quant_20.npz'] and 'invalid scale' in lines[
      'quant_20.npz']
  assert 'QUARANTINED' in lines['old_5.npz.corrupt']
  assert '2 failing' in out
  clean = tmp_path / 'clean'
  clean.mkdir()
  checkpoint.save_train_npz(str(clean / 'c_1.npz'), weights,
                            extras={'step': np.int64(1)}, plan=dist)
  assert verify_checkpoint.main([str(clean), '--json']) == 0
  assert verify_checkpoint.main([str(tmp_path / 'nothing')]) == 2


# --------------------------------------------------------------------------
# resharding across world sizes (two gloo ranks)
# --------------------------------------------------------------------------

RESHARD_SPECS = [(40, 8, 'sum'), (30, 4, 'mean'), (50, 8, None),
                 (24, 4, 'sum')]


def _reshard_rank(rank, world_size, init_method, case_path, out_dir):
  import pickle
  torch.set_num_threads(1)
  torch.distributed.init_process_group('gloo', init_method=init_method,
                                       rank=rank, world_size=world_size)
  try:
    with open(case_path, 'rb') as f:
      case = pickle.load(f)
    from distributed_embeddings_tpu_torch.parallel import mesh
    d = DistributedEmbedding(
        [TableConfig(r, w, combiner=c) for r, w, c in RESHARD_SPECS],
        mesh=mesh.create_mesh('cpu'), column_slice_threshold=100)
    emb_opt = sparse.SparseAdagrad(0.1)
    fresh = sparse.init_hybrid_train_state(
        d, {'embedding': d.init(3), 'kernel': torch.zeros(3, 1)},
        optim.adagrad(0.1), emb_opt)
    state, _ = checkpoint.restore_train_state(d, fresh, case['world1'])
    tables = [t.numpy() for t in checkpoint.get_weights(
        d, state.params['embedding'])]
    accs = [s['acc'].numpy() for s in checkpoint.get_optimizer_state(
        d, state.opt_state[1])]
    for a, b in zip(tables + accs, case['tables'] + case['accs']):
      np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(state.params['kernel'].numpy(),
                                  case['kernel'])
    assert state.step == 9
    # and write a world-2 file of the same state
    callbacks.CheckpointCallback(d, case['world2'], every=1)(9, state, {})
    # the replica digest: the dense copies agree, until rank 1's diverges
    # (a tie of two ranks names both)
    aud = audit.StateAuditor(d, every=1)
    assert aud.check_state(state) == []
    if rank == 1:
      with torch.no_grad():
        state.params['kernel'][2, 0] += 1.0
    found = aud.check_state(state)
    assert [(f.check, f.leaf, f.devices, f.rows) for f in found] == [
        ('replicated', "dense['params']['kernel']", (0, 1), (2,))]
  finally:
    torch.distributed.destroy_process_group()


def test_files_reshard_between_world_one_and_two(tmp_path):
  rng = np.random.default_rng(5)
  tables = [rng.normal(size=(r, w)).astype(np.float32)
            for r, w, _ in RESHARD_SPECS]
  accs = [(np.abs(rng.normal(size=(r, w))) + 0.1).astype(np.float32)
          for r, w, _ in RESHARD_SPECS]
  kernel = rng.normal(size=(3, 1)).astype(np.float32)
  d1 = DistributedEmbedding(
      [TableConfig(r, w, combiner=c) for r, w, c in RESHARD_SPECS],
      device='cpu')
  emb_opt = sparse.SparseAdagrad(0.1)
  state = sparse.init_hybrid_train_state(
      d1, {'embedding': checkpoint.set_weights(d1, tables),
           'kernel': torch.tensor(kernel)}, optim.adagrad(0.1), emb_opt)
  checkpoint.set_optimizer_state(d1, state.opt_state[1],
                                [{'acc': a} for a in accs])
  state = state._replace(step=9)
  world1 = str(tmp_path / 'world1.npz')
  world2 = str(tmp_path / 'world2.npz')
  callbacks.CheckpointCallback(d1, world1, every=1)(9, state, {})
  torch_parity.spawn_ranks(
      _reshard_rank, {'world1': world1, 'world2': world2, 'tables': tables,
                      'accs': accs, 'kernel': kernel}, tmp_path, timeout=120)
  # the world-2 file back into world 1: the same arrays, the same plan
  m1 = checkpoint.read_manifest(world1)['arrays']
  m2 = checkpoint.read_manifest(world2)['arrays']
  assert m1 == m2
  fresh = sparse.init_hybrid_train_state(
      d1, {'embedding': d1.init(4), 'kernel': torch.zeros(3, 1)},
      optim.adagrad(0.1), emb_opt)
  restored, _ = checkpoint.restore_train_state(d1, fresh, world2)
  for a, b in zip(checkpoint.get_weights(d1, restored.params['embedding']),
                  tables):
    np.testing.assert_array_equal(a.numpy(), b)
