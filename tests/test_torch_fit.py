"""The port's ``grad.fit``, its callbacks and the DLRM example's resume
and rollback flags, on the CPU (the port's cases of
tests/test_fault_tolerance.py and tests/test_callbacks.py).

- Kill and resume: a run killed after its step-10 checkpoint resumes
  through ``fit(resume_from=<dir>)`` from a fresh state and ends equal to
  an uninterrupted run, bit for bit (tables, accumulators, dense params
  and state, step).
- Self-healing: a NaN planted in an accumulator row is found by
  ``StateAuditor`` and rolled back in place, bit-exact against the
  undisturbed run; a loss spike rolls back and skips its window; a
  persistent fault exhausts the budget; no checkpoint terminates; the
  watchdog fails fast.
- The port's ``fit`` loss history against JAX ``fit`` on the same state
  and batches: rtol 3e-5 / atol 3e-6, the hybrid ``SparseAdagrad`` step's
  bound (tests/test_torch_train.py).
- The example: ``--save_state`` / ``--load_state`` resume equals the
  uninterrupted run array by array; ``--resume_dir`` falls back past a
  truncated newest file and quarantines it; ``--save_weights``,
  ``--eval_every``, ``--audit_every`` and the refusals.
"""

import os
import time

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import grad as jax_grad
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.utils import faultinject
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
from distributed_embeddings_tpu_torch.parallel import audit
from distributed_embeddings_tpu_torch.parallel import callbacks
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import grad
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.tools import trace_report
from distributed_embeddings_tpu_torch.utils import resilience

import torch_parity

torch.set_num_threads(1)

BATCH = 16
SPECS = [(40, 8, 'sum'), (30, 8, 'mean')]


@pytest.fixture(autouse=True)
def _journal_to_tmp(tmp_path, monkeypatch):
  monkeypatch.setenv('DET_FT_JOURNAL', str(tmp_path / 'ft_journal.jsonl'))
  resilience.clear_recent()


def _head_loss(dense, emb_outs, y):
  x = torch.cat(list(emb_outs), dim=1)
  return torch.mean((x @ dense['kernel'] - torch.as_tensor(y)) ** 2)


def _case(seed=0, n=20):
  rng = np.random.default_rng(seed)
  weights = [rng.normal(size=(r, w)).astype(np.float32) for r, w, _ in SPECS]
  kernel = rng.normal(size=(16, 1)).astype(np.float32)
  r = np.random.default_rng(7)
  data = []
  for _ in range(n):
    cats = [r.integers(0, rows, (BATCH, 2)).astype(np.int32)
            for rows, _, _ in SPECS]
    data.append((cats, r.normal(size=(BATCH, 1)).astype(np.float32)))
  return weights, kernel, data


@pytest.fixture(scope='module')
def hybrid():
  """The port's hybrid trainer: dist, step, fresh_state(), 20 batches and
  the uninterrupted 20-step reference's leaves."""
  dist = DistributedEmbedding([TableConfig(r, w, combiner=c)
                               for r, w, c in SPECS], device='cpu')
  weights, kernel, data = _case()
  dense_opt = optim.adagrad(0.05)
  emb_opt = sparse.SparseAdagrad(learning_rate=0.05)
  step = sparse.make_hybrid_train_step(dist, _head_loss, dense_opt, emb_opt)

  def fresh_state():
    params = {'embedding': checkpoint.set_weights(dist, weights),
              'kernel': torch.tensor(kernel)}
    return sparse.init_hybrid_train_state(dist, params, dense_opt, emb_opt)

  ref, ref_hist = grad.fit(step, fresh_state(), iter(data), steps=20,
                           log_every=5, verbose=False)
  return dist, step, fresh_state, data, _leaves(dist, ref), ref_hist


def _leaves(dist, state):
  """The state's logical content: tables and sparse state in the global
  layout, dense params, dense optimizer leaves, the step."""
  out = [t.clone() for t in checkpoint.get_weights(
      dist, state.params['embedding'])]
  out += [state.params['kernel'].clone()]
  out += [leaf.clone() for _, leaf, _ in
          checkpoint._flatten(state.opt_state[0], opt=True)]
  for entry in checkpoint.get_optimizer_state(dist, state.opt_state[1]):
    out += [entry[k].clone() for k in sorted(entry)]
  return out + [torch.tensor(int(state.step))]


def _assert_bit_exact(want, got):
  assert len(want) == len(got)
  for i, (a, b) in enumerate(zip(want, got)):
    assert torch.equal(a, b), f'leaf {i}'


def test_kill_resume_bit_exact(hybrid, tmp_path):
  dist, step, fresh_state, data, ref_leaves, ref_hist = hybrid
  cb = callbacks.CheckpointCallback(dist, str(tmp_path / 'ckpt_{step}.npz'),
                                    every=10)
  grad.fit(step, fresh_state(), iter(data[:13]), steps=13, log_every=5,
           callbacks=[cb], verbose=False)
  assert (tmp_path / 'ckpt_10.npz').exists()
  msgs = []
  resumed, hist = grad.fit(step, fresh_state(), iter(data[10:]), steps=20,
                           log_every=5, resume_from=str(tmp_path),
                           dist=dist, print_fn=msgs.append)
  assert resumed.step == 20
  assert any('resumed from' in m and 'at step 10' in m for m in msgs)
  _assert_bit_exact(ref_leaves, _leaves(dist, resumed))
  assert hist['loss'][-1] == ref_hist['loss'][-1]
  assert resilience.recent('resume')


def test_restore_train_state_explicit_file(hybrid, tmp_path):
  dist, step, fresh_state, data, _, _ = hybrid
  cb = callbacks.CheckpointCallback(dist, str(tmp_path / 'one.npz'),
                                    every=5)
  trained, _ = grad.fit(step, fresh_state(), iter(data[:5]), steps=5,
                        log_every=5, callbacks=[cb], verbose=False)
  want = _leaves(dist, trained)
  restored, path = checkpoint.restore_train_state(
      dist, fresh_state(), str(tmp_path / 'one.npz'))
  assert path == str(tmp_path / 'one.npz')
  _assert_bit_exact(want, _leaves(dist, restored))
  # a corrupt explicit file raises, and the template is left untouched
  faultinject.flip_bytes(path, count=8, seed=0)
  fresh = fresh_state()
  before = _leaves(dist, fresh)
  with pytest.raises(ValueError, match='invalid checkpoint'):
    checkpoint.restore_train_state(dist, fresh, path)
  _assert_bit_exact(before, _leaves(dist, fresh))


def _poison_acc(row):
  def mutate(state):
    state.opt_state[1]['group_0']['acc'][row, 3] = float('nan')
    return state
  return mutate


def test_audit_poison_rollback_bit_exact(hybrid, tmp_path):
  """A NaN planted in one accumulator row after step 11 is found by the
  audit at step 12, rolled back to the step-10 file in place and
  replayed: the run ends bit-exact against the undisturbed one."""
  dist, step, fresh_state, data, ref_leaves, _ = hybrid
  cb = callbacks.CheckpointCallback(dist, str(tmp_path / 'ckpt_{step}.npz'),
                                    every=5, keep_last=1)
  bad = faultinject.CorruptingStep(step, at_step=10, mutate=_poison_acc(7))
  final, hist = grad.fit(bad, fresh_state(), iter(data), steps=20,
                         log_every=5, callbacks=[cb], verbose=False,
                         on_anomaly='rollback', rollback_dir=str(tmp_path),
                         dist=dist, data_factory=lambda s: iter(data[s:]),
                         auditor=audit.StateAuditor(dist, every=2))
  assert [a['kind'] for a in hist['anomalies']] == ['audit_failure']
  assert hist['anomalies'][0]['step'] == 12
  assert bad.injected == 1 and final.step == 20
  _assert_bit_exact(ref_leaves, _leaves(dist, final))
  fails = resilience.recent('audit_failure')
  assert fails[0]['check'] == 'finite' and fails[0]['leaf'] == 'group_0/acc'
  assert fails[0]['devices'] == [0] and fails[0]['rows'] == [7]
  rb = resilience.recent('rollback')
  assert rb[0]['to_step'] == 10 and rb[0]['path'].endswith('ckpt_10.npz')
  assert sorted(f for f in os.listdir(tmp_path) if 'npz' in f) == [
      'ckpt_20.npz']


def test_rollback_quarantines_a_corrupt_candidate(hybrid, tmp_path):
  """The newest file is corrupt when the rollback comes: it is renamed
  ``*.corrupt`` and the one before it restores."""
  dist, step, fresh_state, data, _, _ = hybrid
  cb = callbacks.CheckpointCallback(dist, str(tmp_path / 'ckpt_{step}.npz'),
                                    every=5)

  def flip_newest(s, state, logs):
    if s == 10 and 'checkpoint' in logs:  # not on the replay
      faultinject.flip_bytes(logs['checkpoint'], count=8, seed=1)

  bad = faultinject.CorruptingStep(step, at_step=11, mutate=_poison_acc(2))
  final, hist = grad.fit(bad, fresh_state(), iter(data), steps=14,
                         log_every=5, callbacks=[cb, flip_newest],
                         verbose=False, on_anomaly='rollback',
                         rollback_dir=str(tmp_path), dist=dist,
                         data_factory=lambda s: iter(data[s:]),
                         auditor=audit.StateAuditor(dist, every=1))
  assert hist['anomalies'][0]['step'] == 12
  assert resilience.recent('rollback')[0]['to_step'] == 5
  assert 'ckpt_10.npz.corrupt' in os.listdir(tmp_path)
  assert final.step == 14


def test_loss_spike_rollback_skip_window(hybrid, tmp_path):
  dist, step, fresh_state, data, _, _ = hybrid
  cb = callbacks.CheckpointCallback(dist, str(tmp_path / 'c_{step}.npz'),
                                    every=5)
  spike = faultinject.LossSpikeStep(step, at_step=11, magnitude=1e7)
  final, hist = grad.fit(spike, fresh_state(), iter(data), steps=20,
                         log_every=5, callbacks=[cb], verbose=False,
                         on_anomaly='rollback_skip',
                         rollback_dir=str(tmp_path), dist=dist,
                         data_factory=lambda s: iter(data[s:]),
                         spike_zscore=6.0)
  assert [a['kind'] for a in hist['anomalies']] == ['loss_spike']
  assert hist['anomalies'][0]['step'] == 12
  sk = resilience.recent('skip_window')
  assert sk and sk[-1]['from_step'] == 10 and sk[-1]['to_step'] == 15
  assert final.step == 15
  assert resilience.recent('anomaly_detected')


def test_rollback_budget_exhaustion_terminates(hybrid, tmp_path):
  dist, step, fresh_state, data, _, _ = hybrid
  data = list(data)
  cats12, y12 = data[12]
  data[12] = (cats12, np.full_like(y12, np.inf))
  cb = callbacks.CheckpointCallback(dist, str(tmp_path / 'c_{step}.npz'),
                                    every=5)
  msgs = []
  _, hist = grad.fit(step, fresh_state(), iter(data), steps=20,
                     log_every=5, callbacks=[cb], verbose=False,
                     print_fn=msgs.append, on_anomaly='rollback',
                     rollback_dir=str(tmp_path), dist=dist,
                     data_factory=lambda s: iter(data[s:]),
                     rollback_budget=2)
  assert len(resilience.recent('rollback')) == 2
  assert resilience.recent('rollback_budget_exhausted')
  assert hist['rollback_budget_exhausted'] is True
  assert [a['kind'] for a in hist['anomalies']] == ['non_finite_loss'] * 3
  assert hist['terminated_on_anomaly'] == 13
  assert any('budget' in m for m in msgs)


def test_rollback_without_checkpoint_terminates(hybrid, tmp_path):
  dist, step, fresh_state, data, _, _ = hybrid
  data = list(data)
  cats2, y2 = data[2]
  data[2] = (cats2, np.full_like(y2, np.nan))
  _, hist = grad.fit(step, fresh_state(), iter(data), steps=20,
                     log_every=5, verbose=False, print_fn=lambda m: None,
                     on_anomaly='rollback', rollback_dir=str(tmp_path),
                     dist=dist, data_factory=lambda s: iter(data[s:]))
  assert resilience.recent('rollback_failed')
  assert hist['terminated_on_anomaly'] == 3
  assert not resilience.recent('rollback')


def _scalar_trainer():
  opt = optim.sgd(0.01)

  def loss_fn(params, x):
    # sqrt(-1) -> NaN on the poisoned batch; params kept in the graph
    return torch.mean(torch.sqrt(torch.as_tensor(x)) + 0.0 * params['w'])

  return grad.make_train_step(loss_fn, opt), grad.init_train_state(
      {'w': torch.ones(())}, opt)


@pytest.mark.parametrize('guard', [{'terminate_on_nan': True},
                                   {'on_anomaly': 'terminate'}])
def test_terminate_on_nan_stops_and_journals(guard):
  step, state = _scalar_trainer()
  data = [(1.0,)] * 20
  data[6] = (-1.0,)
  msgs = []
  _, hist = grad.fit(step, state, iter(data), steps=20, log_every=5,
                     verbose=False, print_fn=msgs.append, **guard)
  assert hist['terminated_on_nan'] == 7
  assert hist['step'] == [5]
  events = resilience.recent('terminate_on_nan')
  assert events and events[-1]['step'] == 7
  assert resilience.recent('anomaly_detected')
  assert any('terminate_on_nan' in m and 'step 7' in m for m in msgs)


def test_nan_flows_silently_without_the_guard():
  step, state = _scalar_trainer()
  data = [(1.0,)] * 20
  data[6] = (-1.0,)
  _, hist = grad.fit(step, state, iter(data), steps=20, log_every=5,
                     verbose=False)
  assert len(hist['step']) == 4
  assert np.isnan(hist['loss'][1])


def test_step_watchdog_fails_fast_and_is_off_by_default():
  step, state = _scalar_trainer()
  slow = faultinject.DelayedStep(step, at_step=3, delay_s=3.0)
  t0 = time.perf_counter()
  with pytest.raises(resilience.StepHangError, match='watchdog'):
    grad.fit(slow, state, iter([(1.0,)] * 10), steps=10, log_every=2,
             step_timeout_s=0.5, verbose=False)
  assert time.perf_counter() - t0 < 3.0
  assert resilience.recent('watchdog_fired')
  step, state = _scalar_trainer()
  final, hist = grad.fit(step, state, iter([(1.0,)] * 4), steps=4,
                         log_every=2, verbose=False, step_timeout_s=30.0)
  assert len(hist['loss']) == 2 and final.step == 4


def test_resilience_primitives():
  assert resilience.call_with_timeout(lambda: 42, 5.0) == 42
  with pytest.raises(ZeroDivisionError):
    resilience.call_with_timeout(lambda: 1 // 0, 5.0)
  sleeps = []
  calls = faultinject.flaky_calls(lambda: 'ok', fail_at=[0], times=2)
  assert resilience.retry_io(calls, retries=3, base_delay_s=0.1,
                             sleep=sleeps.append) == 'ok'
  assert sleeps == [0.1, 0.2]
  with pytest.raises(FileNotFoundError):
    resilience.retry_io(lambda: open('/nonexistent/x'), retries=5,
                        sleep=lambda d: None)
  assert len(resilience.recent('io_retry')) == 2


def test_fit_rollback_requires_dir_and_factory(hybrid):
  dist, step, fresh_state, data, _, _ = hybrid
  with pytest.raises(ValueError, match='rollback_dir'):
    grad.fit(step, fresh_state(), iter(data), steps=1,
             on_anomaly='rollback', dist=dist, verbose=False)
  with pytest.raises(ValueError, match='data_factory'):
    grad.fit(step, fresh_state(), iter(data), steps=1,
             on_anomaly='rollback', dist=dist, rollback_dir='x',
             verbose=False)
  with pytest.raises(ValueError, match='on_anomaly'):
    grad.fit(step, fresh_state(), iter(data), steps=1,
             on_anomaly='explode', verbose=False)
  with pytest.raises(ValueError, match='dist='):
    grad.fit(step, fresh_state(), iter(data), steps=1, resume_from='x',
             verbose=False)


def test_fit_loss_history_matches_jax_fit(hybrid):
  """JAX ``fit`` and the port's on the same state and 8 batches, log
  points every 2 steps."""
  dist, step, fresh_state, data, _, _ = hybrid
  weights, kernel, _ = _case()
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(r, w, combiner=c) for r, w, c in SPECS],
      mesh=torch_parity.jax_mesh(1), packed_storage=False)

  def jax_head(dense, emb_outs, y):
    x = jnp.concatenate(list(emb_outs), axis=1)
    return jnp.mean((x @ dense['kernel'] - y) ** 2)

  jemb = jax_sparse.SparseAdagrad(learning_rate=0.05)
  jstep = jax_sparse.make_hybrid_train_step(jd, jax_head, optax.adagrad(0.05),
                                            jemb, donate=False)
  jstate = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': jax_ckpt.set_weights(jd, weights),
           'kernel': jnp.asarray(kernel)}, optax.adagrad(0.05), jemb)
  jdata = [([jnp.asarray(c) for c in cats], jnp.asarray(y))
           for cats, y in data[:8]]
  _, jhist = jax_grad.fit(jstep, jstate, iter(jdata), steps=8, log_every=2,
                          verbose=False)
  _, phist = grad.fit(step, fresh_state(), iter(data[:8]), steps=8,
                      log_every=2, verbose=False)
  assert phist['step'] == jhist['step'] == [2, 4, 6, 8]
  np.testing.assert_allclose(phist['loss'], jhist['loss'], rtol=3e-5,
                             atol=3e-6)


# --------------------------------------------------------------------------
# callbacks and eval: the cases of tests/test_callbacks.py
# --------------------------------------------------------------------------


def test_checkpoint_callback_resumable(hybrid, tmp_path):
  dist, step, fresh_state, data, _, _ = hybrid
  cb = callbacks.CheckpointCallback(dist, str(tmp_path / 'ckpt_{step}.npz'),
                                    every=10)
  state, _ = grad.fit(step, fresh_state(), iter(data), steps=20,
                      log_every=5, callbacks=[cb], verbose=False)
  assert (tmp_path / 'ckpt_10.npz').exists()
  assert (tmp_path / 'ckpt_20.npz').exists()
  assert not (tmp_path / 'ckpt_5.npz').exists()
  weights, st_tables, extras = checkpoint.load_train_npz(
      str(tmp_path / 'ckpt_20.npz'))
  assert int(extras['step']) == 20
  restored = checkpoint.set_weights(dist, weights)
  for k in restored:
    assert restored[k].shape == state.params['embedding'][k].shape
  assert st_tables and all('acc' in t for t in st_tables)
  assert "dense:['kernel']" in extras
  assert "opt:[0].sum_of_squares['kernel']" in extras


def test_checkpoint_callback_atomic_overwrite_and_retention(hybrid,
                                                            tmp_path):
  dist, step, fresh_state, data, _, _ = hybrid
  path = str(tmp_path / 'latest.npz')
  cb = callbacks.CheckpointCallback(dist, path, every=5)
  grad.fit(step, fresh_state(), iter(data[:10]), steps=10, log_every=5,
           callbacks=[cb], verbose=False)
  assert int(checkpoint.load_train_npz(path)[2]['step']) == 10
  assert [f for f in os.listdir(tmp_path) if 'npz' in f] == ['latest.npz']
  keep = tmp_path / 'keep'
  keep.mkdir()
  cb = callbacks.CheckpointCallback(dist, str(keep / 'ckpt_{step}.npz'),
                                    every=5, keep_last=2)
  grad.fit(step, fresh_state(), iter(data), steps=20, log_every=5,
           callbacks=[cb], verbose=False)
  assert sorted(os.listdir(keep)) == ['ckpt_15.npz', 'ckpt_20.npz']
  assert resilience.recent('checkpoint_pruned')
  with pytest.raises(ValueError, match='keep_last'):
    callbacks.CheckpointCallback(dist, str(keep / 'c_{step}.npz'),
                                 keep_last=0)
  with pytest.raises(ValueError, match='FILE'):
    callbacks.CheckpointCallback(dist, str(keep / '{step}' / 'c.npz'),
                                 keep_last=1)


def test_early_stopping_on_plateau():
  opt = optim.sgd(0.0)

  def loss_fn(params, batch):
    return torch.mean((params['w'] - batch) ** 2)

  step = grad.make_train_step(loss_fn, opt)
  state = grad.init_train_state({'w': torch.ones(())}, opt)
  es = callbacks.EarlyStopping(monitor='loss', patience=2, min_delta=1e-9)
  data = ((torch.zeros(()),) for _ in range(1000))
  _, hist = grad.fit(step, state, data, steps=1000, log_every=10,
                     callbacks=[es], verbose=False)
  assert hist['step'] == [10, 20, 30]


def test_early_stopping_max_mode_keeps_improving():
  es = callbacks.EarlyStopping(monitor='auc', patience=2, mode='max')
  for i, auc in enumerate([0.5, 0.6, 0.7, 0.8], 1):
    es(i, None, {'auc': auc})
  assert es.stale == 0
  with pytest.raises(StopIteration):
    for i in range(5):
      es(10 + i, None, {'auc': 0.8})
  es2 = callbacks.EarlyStopping(monitor='auc', patience=1)
  es2(1, None, {'loss': 1.0})
  with pytest.raises(ValueError, match='mode'):
    callbacks.EarlyStopping(mode='up')


def test_fit_final_eval_at_drained_log_boundary(hybrid):
  dist, step, fresh_state, data, _, _ = hybrid
  calls = []

  def eval_fn(state):
    calls.append(1)
    return {'metric': 42.0}

  _, hist = grad.fit(step, fresh_state(), iter(data[:4]), log_every=2,
                     eval_fn=eval_fn, eval_every=4, verbose=False)
  assert hist['eval_step'] == [4] and len(calls) == 1
  calls.clear()
  _, hist = grad.fit(step, fresh_state(), iter(data[:4]), log_every=2,
                     eval_fn=eval_fn, eval_every=3, verbose=False)
  assert hist['eval_step'] == [4] and len(calls) == 1
  assert hist['metric'] == [42.0]


def test_fit_eval_metric_name_collision_namespaced(hybrid):
  dist, step, fresh_state, data, _, _ = hybrid
  _, hist = grad.fit(step, fresh_state(), iter(data[:4]), log_every=2,
                     eval_fn=lambda s: {'loss': 123.0, 'auc': 0.5},
                     eval_every=2, verbose=False)
  assert len(hist['loss']) == len(hist['step']) == 2
  assert all(v < 100 for v in hist['loss'])
  assert hist['eval_loss'] == [123.0, 123.0]
  assert hist['auc'] == [0.5, 0.5]


def test_checkpoint_callback_detects_dense_only_ambiguous_state(hybrid,
                                                                tmp_path):
  """A 2-tuple opt_state whose second element is a dict but not the
  plan's group dict is dense-only: both halves go under ``opt:``, named
  as the JAX package names them."""
  dist = hybrid[0]
  path = str(tmp_path / 'dense_only.npz')
  cb = callbacks.CheckpointCallback(dist, path, every=1)
  fake_state = type('S', (), {})()
  fake_state.params = {'embedding': dist.init(0)}
  fake_state.opt_state = ({'count': torch.zeros(())},
                          {'not_a_group': torch.zeros(())})
  cb(1, fake_state, {})
  _, st_tables, extras = checkpoint.load_train_npz(path)
  assert not any(st_tables)
  assert "opt:[0]['count']" in extras and "opt:[1]['not_a_group']" in extras


# --------------------------------------------------------------------------
# the DLRM example's checkpoint, resume and self-healing flags
# --------------------------------------------------------------------------

SMALL = ['--device', 'cpu', '--batch_size', '64', '--table_sizes',
         '30,20,50,10', '--embedding_dim', '8', '--bottom_mlp_dims', '16,8',
         '--top_mlp_dims', '16,1', '--num_batches', '6']


def test_example_resume_equals_uninterrupted_run(tmp_path, capsys):
  a, b3, b = (str(tmp_path / n) for n in ('a.npz', 'b3.npz', 'b.npz'))
  out_a = dlrm_main.main(SMALL + ['--save_state', a])
  dlrm_main.main(SMALL + ['--max_steps', '3', '--save_state', b3])
  out_b = dlrm_main.main(SMALL + ['--load_state', b3, '--save_state', b])
  assert out_a['step'] == out_b['step'] == 6
  assert out_b['resumed_from'] == b3 and out_a['loss'] == out_b['loss']
  assert checkpoint.read_manifest(a) == checkpoint.read_manifest(b)
  # --resume_dir: the truncated newest file is quarantined, the older
  # valid one resumes
  d = tmp_path / 'resume'
  d.mkdir()
  os.replace(b3, d / 'ckpt_3.npz')
  with open(b, 'rb') as f, open(d / 'ckpt_6.npz', 'wb') as g:
    g.write(f.read(4096))
  os.utime(d / 'ckpt_3.npz', (3, 3))
  c = str(tmp_path / 'c.npz')
  out_c = dlrm_main.main(SMALL + ['--resume_dir', str(d), '--save_state', c])
  assert out_c['resumed_from'] == str(d / 'ckpt_3.npz')
  assert sorted(os.listdir(d)) == ['ckpt_3.npz', 'ckpt_6.npz.corrupt']
  assert checkpoint.read_manifest(c) == checkpoint.read_manifest(a)
  assert 'resumed from' in capsys.readouterr().out


def test_example_weights_eval_every_and_audit(tmp_path, capsys):
  w = str(tmp_path / 'w.npz')
  dlrm_main.main(SMALL + ['--save_weights', w, '--eval_every', '2',
                          '--eval_batches', '1', '--audit_every', '1'])
  out = capsys.readouterr().out
  assert 'AUC curve: 2:' in out and 'audit: state-integrity' in out
  tables = checkpoint.load_npz(w)
  assert [t.shape for t in tables] == [(30, 8), (20, 8), (50, 8), (10, 8)]
  with pytest.raises(SystemExit, match='resume_dir'):
    dlrm_main.main(SMALL + ['--on_anomaly', 'rollback'])
  with pytest.raises(SystemExit, match='trainer sparse'):
    dlrm_main.main(SMALL + ['--audit_every', '1', '--trainer', 'dense'])
  # --trace (item 14) beside the audit: the audit's spans land in the
  # trace, which the port's report accepts under --strict
  trace = str(tmp_path / 't.json')
  dlrm_main.main(SMALL + ['--max_steps', '2', '--audit_every', '1',
                          '--trace', trace])
  assert trace_report.main([trace, '--strict', '--require',
                            'train/step,audit/check,apply/update']) == 0


def test_example_rollback_restores_and_skips(tmp_path, monkeypatch, capsys):
  """A poisoned accumulator row found by ``--audit_every 1`` rolls back
  to the newest valid file of ``--resume_dir`` and the run goes on; a
  second poisoning past ``--rollback_budget 1`` exits 3."""
  d = tmp_path / 'ckpts'
  d.mkdir()
  dlrm_main.main(SMALL + ['--max_steps', '2', '--save_state',
                          str(d / 'ckpt_2.npz')])
  real = dlrm_main.make_trainer

  def poisoning_trainer(*args, **kwargs):
    step, state = real(*args, **kwargs)

    def bad_step(state, *a):
      # every step that reaches step 3 poisons a table row: the replay
      # after the rollback poisons it again
      state, loss = step(state, *a)
      if state.step == 3:
        with torch.no_grad():
          state.params['embedding']['group_0'][1, 0] = float('nan')
      return state, loss
    return bad_step, state

  monkeypatch.setattr(dlrm_main, 'make_trainer', poisoning_trainer)
  with pytest.raises(SystemExit) as e:
    dlrm_main.main(SMALL + ['--resume_dir', str(d), '--audit_every', '1',
                            '--on_anomaly', 'rollback',
                            '--rollback_budget', '1'])
  assert e.value.code == 3
  out = capsys.readouterr().out
  assert 'restored' in out and 'at step 2' in out and 'exhausted' in out
  assert resilience.recent('rollback')[0]['to_step'] == 2
  assert resilience.recent('skip_window')
