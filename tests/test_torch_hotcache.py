"""The port's frequency-aware hot-row cache (item 7) against the JAX
package's, on the CPU, world of one (the JAX side on a one-device mesh
with natural storage, so both plan the same tables).  The fixtures are
tests/test_hotcache.py's (``CONFIGS``, ``HOT``, ``_ids``); data is drawn
with numpy from a seed.

- ``parallel/hotcache.py``: selection, calibration (shared tables,
  budgets, floors), the serving sets, the analytic K and the exchange
  counters equal the JAX package's exactly.
- ``routing.unique_with_inverse`` equals JAX's bit for bit;
  ``routing.segment_sum`` equals ``dense_segment_sum`` within f32
  re-association (rtol 3e-5 / atol 3e-6, tests/test_sparse_train.py's
  segment-sum bound).
- The cached forward against the uncached one and against JAX's cached
  forward, at ``row_slice`` None and 600: bit-exact at hotness 1
  (``combiner=None`` included), rtol = atol = 1e-6 for multi-hot bags
  (tests/test_hotcache.py's bounds).  Init is canonical;
  ``dp_input=False`` refuses; Adam's split state has the JAX shapes.
- 10 hybrid steps (``SparseSGD``, ``SparseAdagrad``, ``SparseAdam``; the
  accumulator variants under ``slow``, as in JAX) against JAX's cached
  steps and the port's uncached ones: weights at rtol 2e-4 / atol 2e-6,
  optimizer state at 5e-3 / 5e-4 (tests/test_hotcache.py:187-229).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.models import synthetic as jax_synthetic
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import hotcache as jax_hotcache
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import routing as jax_routing
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.models import synthetic
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import hotcache
from distributed_embeddings_tpu_torch.parallel import routing
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

import torch_parity

torch.set_num_threads(1)

SPECS = [(100, 8, 'sum'), (64, 8, 'sum'), (200, 16, 'mean'), (50, 4, None)]
CONFIGS = [TableConfig(r, w, c) for r, w, c in SPECS]
JAX_CONFIGS = [jax_planner.TableConfig(r, w, c) for r, w, c in SPECS]
HOT_IDS = {0: [0, 1, 2, 3, 7, 11], 2: list(range(20)), 3: [5, 49]}


def hot_sets(ids=None, jax_side=False):
  """The same hot sets as either package's ``HotSet``s."""
  cls = jax_hotcache.HotSet if jax_side else hotcache.HotSet
  return {t: cls(t, np.asarray(v)) for t, v in (ids or HOT_IDS).items()}


def _weights(rng):
  return [(rng.normal(size=(c.input_dim, c.output_dim)) * 0.1).astype(
      np.float32) for c in CONFIGS]


def _ids(rng, batch):
  ids = []
  for c in CONFIGS:
    if c.combiner is None:
      x = rng.integers(0, c.input_dim, size=(batch,)).astype(np.int32)
    else:
      x = rng.integers(0, c.input_dim, size=(batch, 3)).astype(np.int32)
      x[rng.integers(0, batch), 1] = -1          # padding
    ids.append(x)
  ids[0][0, 0] = CONFIGS[0].input_dim + 3        # out-of-vocab
  return ids


def _layers(hot=True, **kw):
  """A port layer and a JAX layer (one device) over ``CONFIGS``."""
  pd = DistributedEmbedding(CONFIGS, device='cpu', dp_input=True,
                            hot_cache=hot_sets() if hot else None, **kw)
  jd = JaxDistributedEmbedding(
      JAX_CONFIGS, mesh=torch_parity.jax_mesh(1), dp_input=True,
      packed_storage=False,
      hot_cache=hot_sets(jax_side=True) if hot else None, **kw)
  return pd, jd


# ------------------------------------------------------------ hotcache.py


def test_hotset_validation():
  for bad in ([3, 1, 2], [1, 1, 2], [-1, 2]):
    with pytest.raises(ValueError):
      hotcache.HotSet(0, np.array(bad))
  hs, js = hotcache.HotSet(4, np.arange(9)), jax_hotcache.HotSet(
      4, np.arange(9))
  assert hs.size == js.size and (hs.fingerprint_material()
                                 == js.fingerprint_material())


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_select_hot_rows_matches_jax(seed):
  rng = np.random.default_rng(seed)
  counts = rng.integers(0, 6, size=300)   # many ties, some zeros
  for coverage in (0.05, 0.5, 0.8, 0.99, 1.0):
    for max_rows in (None, 0, 7, 1000):
      np.testing.assert_array_equal(
          hotcache.select_hot_rows(counts, coverage, max_rows),
          jax_hotcache.select_hot_rows(counts, coverage, max_rows))
  with pytest.raises(ValueError, match='coverage'):
    hotcache.select_hot_rows(counts, 0.0)


def _same_sets(got, want):
  assert sorted(got) == sorted(want)
  for t in want:
    assert got[t].table_id == want[t].table_id
    np.testing.assert_array_equal(got[t].ids, want[t].ids)
    assert got[t].coverage == want[t].coverage


def test_calibrate_counts_and_shared_tables_match_jax():
  # two inputs share the table: counts accumulate over both
  batch = [np.array([[0, 0, 1]]), np.array([[0, 2, -1]])]
  for coverage, ids in ((0.6, [0]), (0.9, [0, 1, 2])):
    got = hotcache.calibrate_hot_sets([TableConfig(10, 4, 'sum')], [0, 0],
                                      [batch], coverage=coverage)
    assert list(got[0].ids) == ids
    _same_sets(got, jax_hotcache.calibrate_hot_sets(
        [jax_planner.TableConfig(10, 4, 'sum')], [0, 0], [batch],
        coverage=coverage))


@pytest.mark.parametrize('kw', [
    {}, dict(budget_bytes=2000), dict(min_rows_per_table=5),
    dict(budget_bytes=900, min_rows_per_table=3, state_copies=0)])
def test_calibrate_and_serving_sets_match_jax(kw):
  rng = np.random.default_rng(7)
  itm = [0, 1, 2, 3, 0]
  batches = []
  for _ in range(3):
    cats = _ids(rng, 32)
    batches.append(cats + [cats[0][:, :2]])
  for coverage in (0.5, 0.8):
    _same_sets(hotcache.calibrate_hot_sets(CONFIGS, itm, batches, coverage,
                                           **kw),
               jax_hotcache.calibrate_hot_sets(JAX_CONFIGS, itm, batches,
                                               coverage, **kw))
  kw.pop('state_copies', None)
  _same_sets(hotcache.serving_hot_sets(CONFIGS, itm, batches, **kw),
             jax_hotcache.serving_hot_sets(JAX_CONFIGS, itm, batches, **kw))
  with pytest.raises(ValueError, match='calibration batch'):
    hotcache.calibrate_hot_sets(CONFIGS, itm, [batches[0][:2]])


def test_analytic_hot_sets_match_jax():
  tiny = torch_parity.reduced(synthetic, 'tiny', max_rows=200_000)
  jtiny = torch_parity.reduced(jax_synthetic, 'tiny', max_rows=200_000)
  tables, _, _ = synthetic.expand_tables(tiny)
  jtables, _, _ = jax_synthetic.expand_tables(jtiny)
  for rows in (1024, 5000, 25_000_000):
    for alpha in (0.0, 0.5, 1.0, 1.05, 2.0):
      for coverage in (0.5, 0.85, 0.95):
        assert (hotcache.power_law_hot_k(rows, alpha, coverage)
                == jax_hotcache.power_law_hot_k(rows, alpha, coverage))
  for kw in (dict(alpha=1.05, coverage=0.85),
             dict(alpha=1.05, coverage=0.95, budget_bytes=1 << 20,
                  state_copies=0),
             dict(alpha=1.0, coverage=0.8, budget_bytes=50_000),
             dict(alpha=0.0, coverage=0.3)):
    _same_sets(hotcache.analytic_power_law_hot_sets(tables, **kw),
               jax_hotcache.analytic_power_law_hot_sets(jtables, **kw))
  assert hotcache.hot_row_bytes(16, 1) == jax_hotcache.hot_row_bytes(16, 1)


@dataclasses.dataclass(frozen=True)
class _TwoRanks:
  """Rank 0 of a two-rank world without a process group: the plan and
  the subgroups of a two-rank layer, for the host-side counters."""
  device: torch.device = torch.device('cpu')
  group: object = None
  world_size: int = 2
  rank: int = 0


@pytest.mark.parametrize('ranks,row_slice', [(1, None), (1, 600), (2, 600)])
def test_exchange_counters_match_jax(ranks, row_slice):
  pd = DistributedEmbedding(
      CONFIGS, mesh=_TwoRanks() if ranks == 2 else None,
      device=None if ranks == 2 else 'cpu', dp_input=True,
      row_slice=row_slice, hot_cache=hot_sets())
  jd = JaxDistributedEmbedding(
      JAX_CONFIGS, mesh=torch_parity.jax_mesh(ranks), dp_input=True,
      packed_storage=False, row_slice=row_slice,
      hot_cache=hot_sets(jax_side=True))
  cats = _ids(np.random.default_rng(5), 16)
  for hs, jhs in ((None, None), ({}, {})):
    got = hotcache.measure_exchange_counters(pd, cats, hot_sets=hs)
    want = jax_hotcache.measure_exchange_counters(jd, cats, hot_sets=jhs)
    assert got == want
  assert 0 < got['hot_hit_rate'] or hs == {}
  assert hotcache.replicated_leaf_names(pd.plan) == \
      jax_hotcache.replicated_leaf_names(jd.plan) != []


# -------------------------------------------------------------- routing.py


@pytest.mark.parametrize('seed', range(4))
def test_unique_with_inverse_is_bit_equal_to_jax(seed):
  rng = np.random.default_rng(seed)
  r, n = int(rng.integers(1, 6)), int(rng.integers(1, 64))
  ids = rng.integers(-3, 20, size=(r, n)).astype(np.int32)
  ids[0] = -1 if seed == 0 else ids[0]        # a row with nothing valid
  for cap in (n, max(1, n // 3)):
    got = routing.unique_with_inverse(torch.as_tensor(ids), cap)
    want = jax_routing.unique_with_inverse(jnp.asarray(ids), cap)
    for g, w in zip(got, want):
      assert g.dtype == torch.int32
      np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_segment_sum_matches_dense_segment_sum():
  rng = np.random.default_rng(3)
  seg = rng.integers(-2, 40, size=700).astype(np.int32)   # some dropped
  rows = (rng.normal(size=(90, 5)) * 0.1).astype(np.float32)
  index = rng.integers(0, 90, size=700).astype(np.int32)
  got = routing.segment_sum(torch.as_tensor(seg), torch.as_tensor(rows), 32,
                            torch.as_tensor(index))
  # JAX drops segments >= num only: the negative ones go there
  want = jax_routing.dense_segment_sum(jnp.asarray(np.where(seg < 0, 32, seg)),
                                       jnp.asarray(rows), 32,
                                       row_index=jnp.asarray(index))
  assert got.dtype == torch.float32 and got.shape == (32, 5)
  # JAX's cumsum differences round with the running sum: the segment-sum
  # bound of tests/test_sparse_train.py
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                             atol=3e-6)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize('row_slice', [None, 600])
def test_forward_matches_baseline_and_jax(row_slice):
  off = DistributedEmbedding(CONFIGS, device='cpu', row_slice=row_slice)
  on, jon = _layers(row_slice=row_slice)
  rng = np.random.default_rng(0)
  w = _weights(rng)
  ids = _ids(rng, 8)
  o_off = off.apply(checkpoint.set_weights(off, w), ids)
  o_on = on.apply(checkpoint.set_weights(on, w), ids)
  o_jax = jon.apply(jax_ckpt.set_weights(jon, w),
                    [jnp.asarray(x) for x in ids])
  hotness = [1 if x.ndim == 1 else x.shape[1] for x in ids]
  # multi-hot bags mixing hot and cold ids re-associate the f32 fold;
  # hotness 1 (combiner=None) is bit-exact
  torch_parity.assert_outputs_match(o_on, [o.numpy() for o in o_off],
                                    hotness)
  torch_parity.assert_outputs_match(o_on, o_jax, hotness)
  np.testing.assert_array_equal(o_on[3].numpy(), o_off[3].numpy())


def test_init_is_canonical():
  off = DistributedEmbedding(CONFIGS, device='cpu')
  on, _ = _layers()
  params = on.init(0)
  assert sorted(k for k in params if k.startswith('hot_')) == [
      f'hot_group_{gi}' for gi in on.plan.hot_groups]
  for a, b in zip(checkpoint.get_weights(off, off.init(0)),
                  checkpoint.get_weights(on, params)):
    assert torch.equal(a, b)


def test_requires_dp_input():
  with pytest.raises(ValueError, match='dp_input'):
    DistributedEmbedding(CONFIGS, device='cpu', dp_input=False,
                         hot_cache=hot_sets())


def test_sparse_adam_hot_split_state():
  on = DistributedEmbedding(CONFIGS[:2], device='cpu',
                            hot_cache={0: hot_sets()[0]})
  jon = JaxDistributedEmbedding(
      JAX_CONFIGS[:2], mesh=torch_parity.jax_mesh(1), packed_storage=False,
      hot_cache={0: hot_sets(jax_side=True)[0]})
  assert sparse.SparseAdam.needs_touch
  st = sparse.SparseAdam().init(on, on.init(0))
  jst = jax_sparse.SparseAdam().init(jon, jon.init(0))
  (gi,) = on.plan.hot_groups
  assert jon.plan.hot_groups == [gi]
  hot, jhot = st[f'hot_group_{gi}'], jst[f'hot_group_{gi}']
  for k in ('m', 'v', 't'):
    assert tuple(hot[k].shape) == tuple(jhot[k].shape)
    assert str(hot[k].dtype)[6:] == str(jhot[k].dtype)
  assert sorted(st) == sorted(jst)


def test_synthetic_model_passes_the_hot_cache_through():
  # the reduced tiny model with the bench's analytic hot sets: the cached
  # model draws the same tables and its logits equal the uncached one's
  pcfg, _, num, cats = torch_parity.tiny_inputs(64, seed=3)
  tables, _, _ = synthetic.expand_tables(pcfg)
  sets = hotcache.analytic_power_law_hot_sets(tables, 1.05, 0.85)
  on = synthetic.SyntheticModel(pcfg, dp_input=True, hot_cache=sets,
                                device='cpu').init(0)
  off = synthetic.SyntheticModel(pcfg, dp_input=True, device='cpu').init(0)
  assert on.dist_embedding.hot_enabled and sets
  with torch.no_grad():
    torch.testing.assert_close(on(num, cats), off(num, cats), rtol=1e-6,
                               atol=1e-6)


def test_dense_autodiff_on_a_hot_layer_refuses():
  """Named for the refusal it once expected; it now checks that there is
  none.  The dense autodiff trainer on a hot layer is ported
  (tests/test_torch_hot_dense.py holds it against ``jax.grad``): under
  grad the cached forward equals the no-grad one bit for bit, and the
  backward reaches every table and hot buffer."""
  on, _ = _layers()
  params = {k: v.requires_grad_(True) for k, v in on.init(0).items()}
  ids = _ids(np.random.default_rng(0), 4)
  outs = on.apply(params, ids)
  with torch.no_grad():
    plain = on.apply(params, ids)
  for a, b in zip(outs, plain):
    assert a.requires_grad
    torch.testing.assert_close(a.detach(), b, rtol=0, atol=0)
  sum(o.sum() for o in outs).backward()
  assert all(p.grad is not None for p in params.values())


# ---------------------------------------------------------------- training

OPTIMIZERS = {
    'sgd': lambda m: m.SparseSGD(learning_rate=0.02),
    'adagrad': lambda m: m.SparseAdagrad(learning_rate=0.02),
    'adagrad_sq': lambda m: m.SparseAdagrad(learning_rate=0.02, dedup=False),
    'adagrad_bf16': lambda m: m.SparseAdagrad(learning_rate=0.02,
                                              accum_dtype='bfloat16'),
    'adam': lambda m: m.SparseAdam(learning_rate=0.01),
}


def _train_port(dist, opt, weights, kernel, labels, steps=10, batch=8):
  def head_loss(dense_params, emb_outs, labels):
    h = torch.cat(list(emb_outs), dim=-1)
    return torch.mean((h @ dense_params['kernel'] - labels)**2)

  state = sparse.init_hybrid_train_state(
      dist, {'embedding': checkpoint.set_weights(dist, weights),
             'kernel': torch.tensor(kernel)}, optim.sgd(0.02), opt)
  step = sparse.make_hybrid_train_step(dist, head_loss, optim.sgd(0.02), opt)
  for s in range(steps):
    state, loss = step(state, _ids(np.random.default_rng(100 + s), batch),
                       torch.tensor(labels))
  assert np.isfinite(float(loss))
  return state


def _train_jax(dist, opt, weights, kernel, labels, steps=10, batch=8):
  def head_loss(dense_params, emb_outs, labels):
    h = jnp.concatenate(list(emb_outs), axis=-1)
    return jnp.mean((h @ dense_params['kernel'] - labels)**2)

  state = jax_sparse.init_hybrid_train_state(
      dist, {'embedding': jax_ckpt.set_weights(dist, weights),
             'kernel': jnp.asarray(kernel)}, optax.sgd(0.02), opt)
  step = jax_sparse.make_hybrid_train_step(dist, head_loss, optax.sgd(0.02),
                                           opt, donate=False)
  for s in range(steps):
    state, loss = step(state, [jnp.asarray(x) for x in _ids(
        np.random.default_rng(100 + s), batch)], jnp.asarray(labels))
  assert np.isfinite(float(loss))
  return state


def _assert_state_close(got_w, got_s, want_w, want_s, what):
  for t, (a, b) in enumerate(zip(got_w, want_w)):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=2e-4,
                               atol=2e-6, err_msg=f'{what} table {t}')
  for t, (a, b) in enumerate(zip(got_s, want_s)):
    assert sorted(a) == sorted(b)
    for k in b:
      np.testing.assert_allclose(
          np.asarray(a[k], np.float32), np.asarray(b[k], np.float32),
          rtol=5e-3, atol=5e-4, err_msg=f'{what} state {t}/{k}')


def _host(tables):
  return [{k: v.float().numpy() for k, v in t.items()} if isinstance(t, dict)
          else t.float().numpy() for t in tables]


@pytest.mark.parametrize('optname', [
    'sgd', 'adagrad',
    pytest.param('adagrad_sq', marks=pytest.mark.slow),
    pytest.param('adagrad_bf16', marks=pytest.mark.slow),
    'adam',
])
def test_train_parity_10_steps(optname):
  """Canonical weights and optimizer state after 10 cached steps against
  JAX's cached steps and the port's uncached ones: the split hot/cold
  state is invisible (lazy Adam through the occurrence-count channel)."""
  rng = np.random.default_rng(1)
  weights = _weights(rng)
  kernel = (rng.standard_normal((sum(c.output_dim for c in CONFIGS), 1))
            * 0.1).astype(np.float32)
  labels = rng.integers(0, 2, (8, 1)).astype(np.float32)
  got = {}
  for name, hot in (('off', False), ('on', True)):
    pd, jd = _layers(hot=hot, row_slice=600)
    st = _train_port(pd, OPTIMIZERS[optname](sparse), weights, kernel,
                     labels)
    got[name] = (_host(checkpoint.get_weights(pd, st.params['embedding'])),
                 _host(checkpoint.get_optimizer_state(pd, st.opt_state[1])))
    if hot:
      jst = _train_jax(jd, OPTIMIZERS[optname](jax_sparse), weights, kernel,
                       labels)
      want = (jax_ckpt.get_weights(jd, jst.params['embedding']),
              jax_ckpt.get_optimizer_state(jd, jst.opt_state[1]))
  _assert_state_close(*got['on'], *want, f'{optname} against JAX')
  _assert_state_close(*got['on'], *got['off'], f'{optname} against off')
