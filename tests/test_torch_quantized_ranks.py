"""An int8-quantized layer on two spawned gloo ranks (CPU) against the
JAX package's quantized layer on a 2-device CPU mesh, over
tests/test_hotcache.py's tables at ``row_slice=600`` (the mean table
row-sharded over both ranks), uncached and with hot sets: what a world
of one cannot show is the quantized hot buffers' replicate (owned rows
dequantized, summed over the ranks, requantized on every rank), the
row-shard merge of dequantized partials, and the hot gradients' sum in
rank order feeding the quantized ``apply_hot``.

- The forward of each rank's half: bit-exact at hotness 1, rtol = atol =
  1e-6 for multi-hot bags (tests/test_hotcache.py's bound).
- 2 hybrid steps (``SparseAdagrad``, SGD on a linear head): both ranks
  hold the same exported payload and scale bits, accumulators, hot
  buffers and losses; against JAX every dequantized element within one
  quantization step of its row per step (the bound of JAX's
  tests/test_quantized_storage.py drift test), the accumulators and
  losses within the two-rank hot-cache test's bounds.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import hotcache as jax_hotcache
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import quantization as jq
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)

import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

TABLES = [(100, 8, 'sum'), (64, 8, 'sum'), (200, 16, 'mean'), (50, 4, None)]
HOT = {0: [0, 1, 2, 3, 7, 11], 2: list(range(20)), 3: [5, 49]}
BATCH = 16
STEPS = 2
LR = 0.05


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


def _case():
  rng = np.random.default_rng(29)
  return {
      'tables': TABLES, 'hot': HOT, 'batch': BATCH, 'lr': LR,
      'dtype': 'int8', 'options': dict(row_slice=600),
      'weights': [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
                  for r, w, _ in TABLES],
      'kernel': (rng.standard_normal((sum(w for _, w, _ in TABLES), 1))
                 * 0.1).astype(np.float32),
      'labels': rng.integers(0, 2, (BATCH, 1)).astype(np.float32),
      'cats': _ids(rng, BATCH),
      'batches': [_ids(rng, BATCH) for _ in range(STEPS)],
  }


def _jax(case, hot):
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(*t) for t in TABLES],
      mesh=torch_parity.jax_mesh(2), dp_input=True, packed_storage=False,
      table_dtype=case['dtype'],
      hot_cache=({t: jax_hotcache.HotSet(t, np.asarray(v))
                  for t, v in HOT.items()} if hot else None),
      **case['options'])
  params = jax_ckpt.set_weights(jd, case['weights'])
  outs = jd.apply(params, [jnp.asarray(c) for c in case['cats']])
  dense_opt = optax.sgd(LR)
  emb_opt = jax_sparse.SparseAdagrad(LR)
  state = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': params, 'kernel': jnp.asarray(case['kernel'])},
      dense_opt, emb_opt)

  def head_loss(dense_params, emb_outs, labels):
    x = jnp.concatenate(list(emb_outs), axis=1)
    return jnp.mean((x @ dense_params['kernel'] - labels)**2)

  step = jax_sparse.make_hybrid_train_step(jd, head_loss, dense_opt, emb_opt,
                                           donate=False)
  losses = []
  for cats in case['batches']:
    state, loss = step(state, [jnp.asarray(c) for c in cats],
                       jnp.asarray(case['labels']))
    losses.append(float(loss))
  return {'outs': [np.asarray(o) for o in outs],
          'tables': jax_ckpt.export_tables(jd, state.params['embedding']),
          'accs': [a['acc'] for a in jax_ckpt.get_optimizer_state(
              jd, state.opt_state[1])],
          'losses': np.array(losses)}


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
  case = _case()
  tmp = tmp_path_factory.mktemp('quant_ranks')
  torch_parity.spawn_ranks(torch_exchange_worker.quant, case, tmp)
  got = {}
  for r in range(2):
    for hot in (False, True):
      with np.load(tmp / f'quant{r}_{int(hot)}.npz') as z:
        got[(r, hot)] = dict(z)
  return case, got


@pytest.mark.parametrize('hot', [False, True], ids=['uncached', 'cached'])
def test_two_ranks_quantized_like_jax(ranks, hot):
  case, got = ranks
  want = _jax(case, hot)
  spec = jq.resolve_table_dtype(case['dtype'])
  r0, r1 = got[(0, hot)], got[(1, hot)]
  # both ranks hold the same state, bit for bit
  for key in r0:
    if not key.startswith('o'):
      np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
  assert any(k.startswith('hot_scale_group_') for k in r0) == hot
  hotness = [1 if c is None else 3 for _, _, c in TABLES]
  b = BATCH // 2
  for r, res in ((0, r0), (1, r1)):
    torch_parity.assert_outputs_match(
        [torch.as_tensor(res[f'o{i}']) for i in range(len(TABLES))],
        [o[r * b:(r + 1) * b] for o in want['outs']], hotness)
  for t, w in enumerate(want['tables']):
    payload = r0[f'p{t}'].view(spec.dtype)
    got_vals = jq.dequantize_np(payload, r0[f's{t}'][:, None])
    step = np.maximum(r0[f's{t}'], w.scale)[:, None]
    diff = np.abs(got_vals - w.values())
    assert np.all(diff <= STEPS * step), (t, float((diff / step).max()))
    np.testing.assert_allclose(r0[f'a{t}'], want['accs'][t], rtol=5e-3,
                               atol=5e-4, err_msg=f'accumulator {t}')
  np.testing.assert_allclose(r0['losses'], want['losses'], rtol=2e-4,
                             atol=2e-6)
