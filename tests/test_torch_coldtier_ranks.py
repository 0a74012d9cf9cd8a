"""The host-DRAM cold tier (docs/design.md §12) on 2 and 4 spawned gloo
ranks (CPU) against the JAX package's tiered layer on CPU meshes of the
same size, over tests/test_hotcache.py's tables with hot sets: what a
world of one cannot show is the fetch pre-pass over the global batch
(each port rank holds its slice, and the ranks all-gather their ids over
the tier's own CPU group), per-rank host tails and write-backs, and the
audit's findings gathered over the ranks.

- Tiered against its fully resident twin on the same ranks, bit for bit:
  the forward, then ``STEPS`` hybrid steps of tables, optimizer state
  and losses (f32, int8 and fp8; ``SparseSGD`` and ``SparseAdagrad``).
- Every rank's fetch rows equal JAX's ``coldtier.compute_fetch_rows`` on
  the global batch for that device, with every device's count, and
  ``fetch_stats`` equals JAX's.
- Against JAX's tiered layer: the forward bit-exact at hotness 1 and
  within rtol = atol = 1e-6 above; after the steps, the f32 tables and
  accumulators and the losses at the hot-cache rank tests' bounds
  (tests/test_torch_hotcache_ranks.py), every dequantized element of a
  quantized table within one quantization step of its row per step.
- ``ColdFetchPipeline`` keeps the batches' order (its run equals the
  unpipelined one bit for bit) and reports ``0 <= overlap_pct <= 1``;
  closed early, every rank's worker ends; with the row digests on and a
  default ``StateAuditor`` after every step (collectives of the
  consumer's tier group beside the worker's pre-pass group) the run
  still equals the unpipelined one, with no finding.
- The ``'tier'`` audit finds nothing on a healthy tier and, after the
  last rank flips a byte of its first tail row, that row on that rank,
  on every rank.
"""

import json

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import coldtier as jax_coldtier
from distributed_embeddings_tpu.parallel import hotcache as jax_hotcache
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import quantization as jq
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
from distributed_embeddings_tpu_torch.parallel.planner import (ShardingPlan,
                                                               TableConfig)

import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

TABLES = [(100, 8, 'sum'), (64, 8, 'sum'), (200, 16, 'mean'), (50, 4, None)]
HOT = {0: [0, 1, 2, 3, 7, 11], 2: list(range(20)), 3: [5, 49]}
BATCH = 16
STEPS = 3
LR = 0.05
# world -> (table_dtype, optimizer) variants
VARIANTS = {
    2: [(None, 'adagrad'), ('int8', 'sgd'), ('float8_e4m3', 'adagrad')],
    4: [(None, 'sgd'), ('int8', 'adagrad')],
}


def _ids(rng, batch):
  ids = []
  for r, _, c in TABLES:
    if c is None:
      x = rng.integers(0, r, size=(batch,)).astype(np.int32)
    else:
      x = rng.integers(0, r, size=(batch, 3)).astype(np.int32)
      x[rng.integers(0, batch), 1] = -1
    ids.append(x)
  return ids


def _budget(world, dtype):
  """60 % of the untiered plan's resident bytes (JAX's ``_tiered``)."""
  plan = ShardingPlan([TableConfig(*t) for t in TABLES], world_size=world,
                      hot_sets={t: HotSet(t, np.asarray(v))
                                for t, v in HOT.items()},
                      table_dtype=dtype, packed_storage=False)
  return int(plan.resident_table_bytes() * 0.6)


def _case(world):
  rng = np.random.default_rng(31 + world)
  return {
      'tables': TABLES, 'hot': HOT, 'batch': BATCH, 'lr': LR,
      'variants': VARIANTS[world],
      'budgets': [_budget(world, d) for d, _ in VARIANTS[world]],
      'weights': [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
                  for r, w, _ in TABLES],
      'kernel': (rng.standard_normal((sum(w for _, w, _ in TABLES), 1))
                 * 0.1).astype(np.float32),
      'labels': rng.integers(0, 2, (BATCH, 1)).astype(np.float32),
      'cats': _ids(rng, BATCH),
      'batches': [_ids(rng, BATCH) for _ in range(STEPS)],
  }


def _jax(case, world, vi):
  dtype, opt_name = case['variants'][vi]
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(*t) for t in TABLES],
      mesh=torch_parity.jax_mesh(world), dp_input=True, packed_storage=False,
      table_dtype=dtype,
      hot_cache={t: jax_hotcache.HotSet(t, np.asarray(v))
                 for t, v in HOT.items()},
      cold_tier=True, device_hbm_budget=case['budgets'][vi])
  assert jd.plan.cold_tier_groups
  params = jax_ckpt.set_weights(jd, case['weights'])
  cats = [jnp.asarray(c) for c in case['cats']]
  outs = jd.apply(params, cats)
  prepped, _, _ = jd._prepare_inputs(cats)
  rows, counts = jax_coldtier.compute_fetch_rows(jd, prepped)
  stats = jax_coldtier.fetch_stats(jd, jd.build_cold_fetch(cats))
  dense_opt = optax.sgd(LR)
  emb_opt = (jax_sparse.SparseSGD(LR) if opt_name == 'sgd'
             else jax_sparse.SparseAdagrad(LR))
  state = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': params, 'kernel': jnp.asarray(case['kernel'])},
      dense_opt, emb_opt)

  def head_loss(dense_params, emb_outs, labels):
    x = jnp.concatenate(list(emb_outs), axis=1)
    return jnp.mean((x @ dense_params['kernel'] - labels)**2)

  step = jax_sparse.make_hybrid_train_step(jd, head_loss, dense_opt, emb_opt,
                                           donate=False)
  losses = []
  for c in case['batches']:
    state, loss = step(state, [jnp.asarray(x) for x in c],
                       jnp.asarray(case['labels']))
    losses.append(float(loss))
  return {'jd': jd, 'outs': [np.asarray(o) for o in outs], 'rows': rows,
          'counts': counts, 'stats': stats,
          'tables': jax_ckpt.export_tables(jd, state.params['embedding']),
          'state': jax_ckpt.get_optimizer_state(jd, state.opt_state[1]),
          'losses': np.array(losses)}


@pytest.fixture(scope='module', params=[2, 4], ids=['world2', 'world4'])
def ranks(request, tmp_path_factory):
  world = request.param
  case = _case(world)
  tmp = tmp_path_factory.mktemp(f'tier_ranks{world}')
  torch_parity.spawn_ranks(torch_exchange_worker.tier, case, tmp,
                           world_size=world, timeout=400)
  got = {}
  for r in range(world):
    for vi in range(len(case['variants'])):
      with np.load(tmp / f'tier{r}_{vi}.npz') as z:
        got[(r, vi)] = dict(z)
  return world, case, got


def _variants(ranks):
  world, case, _ = ranks
  return range(len(case['variants']))


def test_tiered_equals_resident_twin_on_ranks(ranks):
  """Tier membership is layout: every rank's tiered forward, tables,
  optimizer state and losses equal its resident twin's bit for bit, and
  every rank holds the same gathered state."""
  world, case, got = ranks
  for vi in _variants(ranks):
    for r in range(world):
      g = got[(r, vi)]
      for i in range(len(TABLES)):
        np.testing.assert_array_equal(g[f'ot{i}'], g[f'ou{i}'],
                                      err_msg=f'{vi} forward {i}')
      for k in g:
        if k.startswith('t_'):
          np.testing.assert_array_equal(g[k], g['u_' + k[2:]],
                                        err_msg=f'variant {vi} {k}')
          np.testing.assert_array_equal(g[k], got[(0, vi)][k],
                                        err_msg=f'rank {r} {k}')


def test_fetch_rows_match_jax_global_batch(ranks):
  """Each rank's pre-pass over its slice (gathered over the tier group)
  yields JAX's rows for that device from the global batch, every
  device's counts, and JAX's ``fetch_stats``."""
  world, case, got = ranks
  for vi in _variants(ranks):
    want = _jax(case, world, vi)
    jd = want['jd']
    for gi in jd.plan.cold_tier_groups:
      for r in range(world):
        g = got[(r, vi)]
        np.testing.assert_array_equal(g[f'rows{gi}'], want['rows'][gi][r])
        np.testing.assert_array_equal(g[f'counts{gi}'],
                                      np.array(want['counts'][gi]))
    stats = json.loads(str(got[(0, vi)]['fetch_stats']))
    for k in ('cold_tier_fetch_rows', 'cold_tier_fetch_bytes',
              'cold_tier_fetch_scale_bytes',
              'cold_tier_fetch_rows_per_group',
              'cold_tier_row_bytes_per_group'):
      assert stats[k] == want['stats'][k], k


def test_tiered_ranks_like_jax(ranks):
  """Against JAX's tiered layer on a mesh of the same size."""
  world, case, got = ranks
  hotness = [1 if c is None else 3 for _, _, c in TABLES]
  b = BATCH // world
  for vi in _variants(ranks):
    dtype, opt_name = case['variants'][vi]
    want = _jax(case, world, vi)
    for r in range(world):
      g = got[(r, vi)]
      torch_parity.assert_outputs_match(
          [torch.as_tensor(g[f'ot{i}']) for i in range(len(TABLES))],
          [o[r * b:(r + 1) * b] for o in want['outs']], hotness)
    g = got[(0, vi)]
    for t, w in enumerate(want['tables']):
      if dtype is None:
        np.testing.assert_allclose(g[f't_w{t}'], np.asarray(w), rtol=2e-4,
                                   atol=2e-6, err_msg=f'{vi} table {t}')
        continue
      spec = jq.resolve_table_dtype(dtype)
      payload = g[f't_p{t}'].view(spec.dtype)
      vals = jq.dequantize_np(payload, g[f't_s{t}'][:, None])
      step = np.maximum(g[f't_s{t}'], w.scale)[:, None]
      diff = np.abs(vals - w.values())
      assert np.all(diff <= STEPS * step), (vi, t,
                                            float((diff / step).max()))
    if opt_name == 'adagrad':
      for t, st in enumerate(want['state']):
        np.testing.assert_allclose(g[f't_acc{t}'], np.asarray(st['acc']),
                                   rtol=5e-3, atol=5e-4,
                                   err_msg=f'{vi} accumulator {t}')
    np.testing.assert_allclose(g['t_losses'], want['losses'], rtol=2e-4,
                               atol=2e-6)


def test_pipeline_keeps_order_and_overlap_bounds(ranks):
  world, case, got = ranks
  for r in range(world):
    g = got[(r, 0)]
    for k in g:
      if k.startswith('pipe_') and k != 'pipe_stats':
        np.testing.assert_array_equal(g[k], g['t_' + k[5:]], err_msg=k)
    stats = json.loads(str(g['pipe_stats']))
    assert stats['batches'] == STEPS
    assert 0.0 <= stats['overlap_pct'] <= 1.0


def test_pipeline_with_digests_and_audit_on_ranks(ranks):
  """The pipeline's pre-pass group beside the digest checks and the
  audit sweeps: the same tables, optimizer state and losses as the
  unpipelined run, every audit clean, and an early-closed pipeline's
  worker ended on every rank."""
  world, case, got = ranks
  for r in range(world):
    g = got[(r, 0)]
    assert not bool(g['early_alive'])
    run = json.loads(str(g['apipe_findings']))
    assert run == {'audits': STEPS, 'digests': True, 'findings': []}, run
    keys = [k for k in g if k.startswith('apipe_') and k != 'apipe_findings']
    assert len(keys) > 1
    for k in keys:
      np.testing.assert_array_equal(g[k], g['t_' + k[6:]], err_msg=k)


def test_tier_audit_finds_corrupt_row_on_every_rank(ranks):
  world, case, got = ranks
  for r in range(world):
    g = got[(r, 0)]
    assert int(g['audit_healthy']) == 0
    found = json.loads(str(g['audit_found']))
    assert [f[0] for f in found] == ['tier']
    assert found[0][2] == [world - 1] and found[0][3] == [0], found
