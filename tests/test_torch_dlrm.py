"""The port's DLRM and its example's pieces against the JAX package's, on
the CPU: ``dot_interact``, the model's logits with the JAX weights
carried across, three model-parallel-input training steps, the learning
rate schedule, scheduled SGD, the AUC metrics, the data generators and
the entry point.

Bounds:
- ``dot_interact``: rtol 1e-5 (tests/test_dlrm.py:52).
- f32 logits: rtol = atol = 1e-5 (the matmuls may accumulate in another
  order).  bf16 compute: rtol = atol = 2e-2.  The two sides round the
  same bf16 values at different places (JAX rounds a layer's product,
  then adds the bias and rounds again; ``torch.nn.functional.linear``
  adds the bias before its one rounding), so single logits differ by a
  bf16 ulp: measured 0.015625 at most on these inputs, one ulp of a
  logit of 2.42 (the largest is 2.42; f32 logits differ by 2.4e-7).
- Three ``SparseSGD`` + ``optim.sgd(schedule)`` steps: losses, tables
  and MLPs at rtol = atol = 1e-5.
- The schedule, scheduled SGD, the AUC metrics and the data generators:
  bit-exact.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.models import dlrm as jax_dlrm
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.utils import data as jax_data
from distributed_embeddings_tpu.utils import metrics as jax_metrics
from distributed_embeddings_tpu.utils import schedules as jax_schedules
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
from distributed_embeddings_tpu_torch.models import dlrm
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import hotcache
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.tools import trace_report
from distributed_embeddings_tpu_torch.utils import data, metrics, schedules

from examples.dlrm import gen_data

import torch_parity

torch.set_num_threads(1)

TABLE_SIZES = [30, 20, 50, 10, 40, 25, 15, 35]  # tests/test_dlrm.py:20
SMALL = dict(embedding_dim=8, bottom_mlp_dims=[16, 8], top_mlp_dims=[16, 1],
             num_numerical_features=4)
BATCH = 32


def _pair(dp_input=False, jax_dtypes=(), port_dtypes=()):
  """A JAX DLRM on a one-device mesh, initialised, and the port's twin
  with the JAX weights carried across."""
  jm = jax_dlrm.DLRM(table_sizes=TABLE_SIZES, mesh=torch_parity.jax_mesh(1),
                     dp_input=dp_input, **dict(jax_dtypes), **SMALL)
  jparams = jm.init(0)
  pm = dlrm.DLRM(TABLE_SIZES, dp_input=dp_input, device='cpu',
                 **dict(port_dtypes), **SMALL)
  pm.load_jax_params(
      jax_ckpt.get_weights(jm.dist_embedding, jparams['embedding']),
      jax.tree.map(np.asarray, {k: v for k, v in jparams.items()
                                if k != 'embedding'}))
  return jm, jparams, pm


def _batch(seed, plan=None):
  """Numerical features, categorical ids (in worker order when ``plan``
  is given) and labels with a learnable rule."""
  rng = np.random.default_rng(seed)
  numerical = rng.normal(size=(BATCH, 4)).astype(np.float32)
  cats = [rng.integers(0, s, size=(BATCH,)).astype(np.int32)
          for s in TABLE_SIZES]
  labels = (cats[0] % 2 == 0).astype(np.float32)[:, None]
  if plan is not None:
    cats = [cats[i] for dev in plan.input_ids_list for i in dev]
  return numerical, cats, labels


def test_dot_interact_matches_jax():
  rng = np.random.default_rng(0)
  bottom = rng.normal(size=(6, 5)).astype(np.float32)
  embs = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(4)]
  got = dlrm.dot_interact([torch.as_tensor(e) for e in embs],
                          torch.as_tensor(bottom))
  want = jax_dlrm.dot_interact([jnp.asarray(e) for e in embs],
                               jnp.asarray(bottom))
  assert tuple(got.shape) == (6, 5 * 4 // 2 + 5) == want.shape
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
  # the bottom output follows the pairs, unchanged
  np.testing.assert_array_equal(got[:, -5:].numpy(), bottom)


@pytest.mark.parametrize('dp_input,compute,tol', [
    (True, 'float32', 1e-5), (False, 'float32', 1e-5),
    (False, 'bfloat16', 2e-2)], ids=['dp_f32', 'mp_f32', 'mp_bf16'])
def test_logits_match_jax(dp_input, compute, tol):
  jm, jparams, pm = _pair(
      dp_input, jax_dtypes={'compute_dtype': jnp.dtype(compute)},
      port_dtypes={'compute_dtype': getattr(torch, compute)})
  assert pm.num_interaction_features == jm.num_interaction_features
  numerical, cats, _ = _batch(1, None if dp_input else
                              pm.dist_embedding.plan)
  want = np.asarray(jm.apply(jparams, numerical, cats))
  with torch.no_grad():
    got = pm(numerical, cats)
  assert tuple(got.shape) == (BATCH, 1) and got.dtype == torch.float32
  np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_three_mp_training_steps_match_jax():
  """The example's trainer at a small size, on a schedule cut short so
  three steps cross warm-up and plateau: ``SparseSGD`` on the tables,
  scheduled SGD on the MLPs, mean BCE, ``dp_input=False``."""
  jm, jparams, pm = _pair(dp_input=False)
  jdist, pdist = jm.dist_embedding, pm.dist_embedding
  jsched = jax_schedules.warmup_poly_decay_schedule(0.5, 2, 3, 4)
  psched = schedules.warmup_poly_decay_schedule(0.5, 2, 3, 4)

  def jax_head_loss(dense_params, emb_outs, batch):
    numerical, labels = batch
    return jax_dlrm.bce_with_logits(
        jm.head(dense_params, numerical, emb_outs), labels)

  def port_head_loss(dense_params, emb_outs, batch):
    numerical, labels = batch
    return dlrm.bce_with_logits(pm.head(dense_params, numerical, emb_outs),
                                labels)

  jopt = optax.sgd(jsched)
  jstate = jax_sparse.init_hybrid_train_state(jdist, jparams, jopt,
                                              jax_sparse.SparseSGD(0.5))
  jstep = jax_sparse.make_hybrid_train_step(
      jdist, jax_head_loss, jopt, jax_sparse.SparseSGD(0.5),
      lr_schedule=jsched, donate=False)
  popt = optim.sgd(psched)
  pstate = sparse.init_hybrid_train_state(
      pdist, {'embedding': pm.embedding_params, **pm.dense_params()}, popt,
      sparse.SparseSGD(0.5))
  pstep = sparse.make_hybrid_train_step(pdist, port_head_loss, popt,
                                        sparse.SparseSGD(0.5),
                                        lr_schedule=psched)
  for i in range(3):
    numerical, cats, labels = _batch(10 + i, pdist.plan)
    jstate, jloss = jstep(jstate, [jnp.asarray(c) for c in cats],
                          (jnp.asarray(numerical), jnp.asarray(labels)))
    pstate, ploss = pstep(pstate, cats, (numerical, labels))
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5,
                               atol=1e-5, err_msg=f'step {i}')
  assert pstate.step == int(jstate.step) == 3
  assert pstate.opt_state[0] == {'count': 3}
  want = jax_ckpt.get_weights(jdist, jstate.params['embedding'])
  got = checkpoint.get_weights(pdist, pstate.params['embedding'])
  for i, (g, w) in enumerate(zip(got, want)):
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5,
                               err_msg=f'table {i}')
  dense = pm.dense_from_jax(jax.tree.map(
      np.asarray, {k: v for k, v in jstate.params.items()
                   if k != 'embedding'}))
  assert sorted(dense) == sorted(pm.dense_params())
  for k, w in dense.items():
    np.testing.assert_allclose(pstate.params[k].detach().numpy(), w.numpy(),
                               rtol=1e-5, atol=1e-5, err_msg=k)


def test_schedule_is_bit_exact():
  # the example's constants (examples/dlrm/main.py:417-420)
  kw = dict(base_lr=24.0, warmup_steps=8000, decay_start_step=48000,
            decay_steps=24000)
  jsched = jax_schedules.warmup_poly_decay_schedule(**kw)
  psched = schedules.warmup_poly_decay_schedule(**kw)
  for step in (0, 1, 7999, 8000, 47999, 48000, 60000, 72000, 80000):
    got, want = psched(step), np.asarray(jsched(step))
    assert got.dtype == np.float32 and want.dtype == np.float32
    assert got.tobytes() == want.tobytes(), (step, got, want)
  # an odd power takes the binary powering's other branch
  jsched = jax_schedules.warmup_poly_decay_schedule(0.3, 3, 5, 7, 3)
  psched = schedules.warmup_poly_decay_schedule(0.3, 3, 5, 7, 3)
  for step in range(14):
    assert psched(step).tobytes() == np.asarray(jsched(step)).tobytes()


def test_scheduled_sgd_matches_optax():
  sched_kw = dict(base_lr=0.3, warmup_steps=2, decay_start_step=3,
                  decay_steps=5)
  rng = np.random.default_rng(3)
  params = {'a': rng.normal(size=(5, 3)).astype(np.float32),
            'b': rng.normal(size=(4,)).astype(np.float32)}
  grads = [{k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in params.items()} for _ in range(3)]
  jopt = optax.sgd(jax_schedules.warmup_poly_decay_schedule(**sched_kw))
  popt = optim.sgd(schedules.warmup_poly_decay_schedule(**sched_kw))
  for dtype in ('float32', 'bfloat16'):
    jp = {k: jnp.asarray(v, dtype) for k, v in params.items()}
    pp = {k: torch.tensor(v).to(getattr(torch, dtype))
          for k, v in params.items()}
    js, ps = jopt.init(jp), popt.init(pp)
    assert ps == {'count': 0}
    for g in grads:
      ju, js = jopt.update({k: jnp.asarray(v, dtype) for k, v in g.items()},
                           js, jp)
      jp = optax.apply_updates(jp, ju)
      pu, ps = popt.update({k: torch.tensor(v).to(getattr(torch, dtype))
                            for k, v in g.items()}, ps, pp)
      pp = {k: pp[k] + pu[k] for k in pp}
    assert ps == {'count': 3}
    for k in params:
      np.testing.assert_array_equal(pp[k].float().numpy(),
                                    np.asarray(jp[k], np.float32),
                                    err_msg=f'{dtype} {k}')


def test_auc_metrics_match_jax():
  rng = np.random.default_rng(4)
  ours, theirs = metrics.StreamingAUC(200), jax_metrics.StreamingAUC(200)
  for _ in range(3):
    labels = rng.integers(0, 2, size=(64, 1)).astype(np.float32)
    preds = np.clip(0.3 * labels + rng.uniform(size=(64, 1)) * 0.7, 0, 1)
    preds[::9] = 0.5  # ties
    ours.update(labels, preds)
    theirs.update(labels, preds)
    assert metrics.exact_auc(labels, preds) == jax_metrics.exact_auc(
        labels, preds)
  assert ours.result() == theirs.result()
  np.testing.assert_array_equal(ours.true_positives, theirs.true_positives)
  assert metrics.StreamingAUC().result() == 0.0
  with pytest.raises(ValueError):
    metrics.StreamingAUC(1)


def test_data_generators_match_jax():
  assert data.MLPERF_SIZES == gen_data.MLPERF_SIZES
  assert sum(data.MLPERF_SIZES) == 187_767_399
  sizes = [max(4, s // 1000) for s in data.MLPERF_SIZES]
  got = list(data.generate_split(np.random.default_rng(5), sizes, 300, 3.0,
                                 13, chunk=128))
  want = list(gen_data.generate_split(np.random.default_rng(5), sizes, 300,
                                      3.0, 13, chunk=128))
  assert len(got) == len(want) == 3
  for (gl, gn, gc), (wl, wn, wc) in zip(got, want):
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(gn, wn)
    assert len(gc) == len(wc) == 26
    for a, b in zip(gc, wc):
      assert a.dtype == b.dtype
      np.testing.assert_array_equal(a, b)
  for size in (3, 200, 40_000, 2**31 - 2):
    assert data.smallest_int_dtype(size) == jax_data.smallest_int_dtype(size)
  for dp in (True, False):
    a = data.DummyDataset(16, 4, 3, 2, num_workers=2, dp_input=dp)
    b = jax_data.DummyDataset(16, 4, 3, 2, num_workers=2, dp_input=dp)
    assert len(a) == len(b) == 2
    for (an, ac, al), (bn, bc, bl) in zip(a, b):
      np.testing.assert_array_equal(an, bn)
      np.testing.assert_array_equal(al, bl)
      for x, y in zip(ac, bc):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


SMALL_FLAGS = ['--device', 'cpu', '--batch_size', '64', '--table_sizes',
               '30,20,50,10', '--embedding_dim', '8', '--bottom_mlp_dims',
               '16,8', '--top_mlp_dims', '16,1', '--num_numerical_features',
               '4']


def test_entry_point_trains_and_evaluates(capsys):
  dlrm_main.main(SMALL_FLAGS + ['--max_steps', '3', '--eval',
                                '--eval_batches', '1', '--param_dtype',
                                'bfloat16'])
  out = capsys.readouterr().out
  assert 'step: 0  loss: ' in out
  assert 'trained 192 samples in ' in out
  assert 'Evaluation completed, AUC: 0.00000' in out  # labels all one


@pytest.mark.parametrize('flags,item', [
    (['--csr_feed'], '15'),
    (['--on_batch_error', 'skip'], '15')])
def test_entry_point_refuses_unported_flags(flags, item):
  with pytest.raises(NotImplementedError, match=f'item {item}\\)'):
    dlrm_main.main(SMALL_FLAGS + flags)


def test_entry_point_writes_its_trace(tmp_path, capsys):
  """``--trace`` (item 14): every step of the loop is one ``train/step``
  span with the step's phase spans inside; the report accepts the file
  under ``--strict``, and the run leaves the layer off."""
  path = str(tmp_path / 'trace.json')
  dlrm_main.main(SMALL_FLAGS + ['--dp_input', '--max_steps', '3', '--trace',
                                path])
  assert f'obs trace: ' in capsys.readouterr().out
  assert not obs_trace.enabled() and obs_trace.event_count() == 0
  phases = 'train/step,fwd/exchange,fwd/lookup_combine,bwd/exchange,' \
      'apply/update'
  assert trace_report.main([path, '--strict', '--require', phases]) == 0
  events = trace_report.load_trace(path)
  rep = trace_report.report(events)
  assert [s['step'] for s in rep['steps']] == [1, 2, 3]
  assert all(set(phases.split(',')[1:]) <= set(s['phases'])
             for s in rep['steps'])
  # one train/step a step: the step function's, the loop adds none
  assert sum(e['name'] == 'train/step' for e in events
             if e.get('ph') == 'X') == 3


def test_entry_point_trains_with_the_hot_cache(capsys, tmp_path):
  # --hot_cache and --hot_budget_mb are ported (item 7): calibrate, train,
  # save; the file loads into the same run without the cache, tables equal
  path = str(tmp_path / 'hot.npz')
  out = dlrm_main.main(SMALL_FLAGS + [
      '--dp_input', '--hot_cache', '--hot_budget_mb', '8', '--hot_coverage',
      '0.9', '--hot_calib_batches', '1', '--max_steps', '3', '--save_state',
      path])
  assert 'hot_cache: calibrated 4 hot rows over 4 table(s) from 1 ' \
      'batch(es) (coverage target 0.9)' in capsys.readouterr().out
  assert out['step'] == 3 and np.isfinite(out['loss'])
  args = dlrm_main.build_parser().parse_args(SMALL_FLAGS + ['--dp_input'])
  model = dlrm.DLRM(table_sizes=[30, 20, 50, 10], dp_input=True,
                    device='cpu', **SMALL).init(0)
  step, state = dlrm_main.make_trainer(model, args.trainer,
                                       args.learning_rate)
  state, _ = checkpoint.restore_train_state(model.dist_embedding, state,
                                            path)
  weights, _, _ = checkpoint.load_train_npz(path)
  for a, b in zip(checkpoint.export_tables(model.dist_embedding,
                                           state.params['embedding']),
                  weights):
    np.testing.assert_array_equal(a, b)


def _state_arrays(path):
  with np.load(path) as z:
    return {k: z[k] for k in z.files}


def test_entry_point_trains_chunked_as_unchunked(tmp_path):
  # --overlap_chunks is ported (item 8): the chunked run saves the very
  # arrays of the unchunked one
  got = {}
  for chunks in (1, 3):
    path = str(tmp_path / f'c{chunks}.npz')
    out = dlrm_main.main(SMALL_FLAGS + [
        '--dp_input', '--overlap_chunks', str(chunks), '--max_steps', '3',
        '--save_state', path])
    assert out['step'] == 3 and np.isfinite(out['loss'])
    got[chunks] = _state_arrays(path)
  assert sorted(got[1]) == sorted(got[3])
  for k in got[1]:
    np.testing.assert_array_equal(got[1][k], got[3][k], err_msg=k)


def test_entry_point_trains_with_the_per_group_exchange(capsys):
  out = dlrm_main.main(SMALL_FLAGS + ['--no-fused_exchange', '--dp_input',
                                      '--overlap_chunks', '2',
                                      '--max_steps', '2'])
  assert out['step'] == 2 and np.isfinite(out['loss'])
  assert 'trained 128 samples in ' in capsys.readouterr().out


@pytest.mark.parametrize('flags', [['--overlap_chunks', '2'],
                                   ['--overlap_chunks', '2', '--dp_input',
                                    '--trainer', 'dense']],
                         ids=['mp_input', 'dense'])
def test_entry_point_overlap_refusals_match_jax(flags):
  # the JAX example refuses before it builds anything
  from examples.dlrm import main as jax_main
  import sys
  jax_flags = [f for f in SMALL_FLAGS if f not in ('--device', 'cpu')]
  argv, sys.argv = sys.argv, ['main.py'] + jax_flags + flags
  try:
    with pytest.raises(SystemExit) as want:
      jax_main.main()
  finally:
    sys.argv = argv
  with pytest.raises(SystemExit) as got:
    dlrm_main.main(SMALL_FLAGS + flags)
  assert str(got.value) == str(want.value)
  assert '--overlap_chunks > 1' in str(got.value)


@pytest.mark.parametrize('flags,why', [
    (['--hot_cache'], 'requires --dp_input'),
    (['--dp_input', '--hot_cache', '--trainer', 'dense'],
     'pairs with --trainer sparse')])
def test_entry_point_hot_cache_refusals(flags, why):
  with pytest.raises(SystemExit, match=why):
    dlrm_main.main(SMALL_FLAGS + flags)


def test_entry_point_parses_the_jax_flags():
  # every flag of examples/dlrm/main.py, with its default; --device is
  # the port's one addition
  from examples.dlrm import main as jax_main
  import sys
  argv, sys.argv = sys.argv, ['main.py']
  try:
    want = vars(jax_main.parse_args())
  finally:
    sys.argv = argv
  got = vars(dlrm_main.build_parser().parse_args([]))
  assert got.pop('device') == 'cuda'
  assert got == want
  with pytest.raises(ValueError, match='XLA'):
    dlrm_main.main(SMALL_FLAGS + ['--fast_compile'])


def test_bottom_mlp_must_end_at_embedding_dim():
  with pytest.raises(ValueError, match='embedding_dim'):
    dlrm.DLRM([10], embedding_dim=8, bottom_mlp_dims=[16, 4],
              top_mlp_dims=[1], num_numerical_features=2, device='cpu')


def test_dlrm_passes_the_hot_cache_through():
  # item 7 is ported: DLRM(hot_cache=...) builds its layer with the cache,
  # and its logits equal the uncached model's
  hot = {0: hotcache.HotSet(0, np.arange(2)), 2: hotcache.HotSet(
      2, np.array([4, 9]))}
  on = dlrm.DLRM([10, 20, 30], hot_cache=hot, device='cpu', **SMALL).init(0)
  off = dlrm.DLRM([10, 20, 30], device='cpu', **SMALL).init(0)
  assert on.dist_embedding.hot_enabled
  rng = np.random.default_rng(0)
  numerical = rng.normal(size=(6, 4)).astype(np.float32)
  cats = [rng.integers(0, n, size=(6,)).astype(np.int32) for n in (10, 20,
                                                                   30)]
  with torch.no_grad():
    assert torch.equal(on(numerical, cats), off(numerical, cats))
