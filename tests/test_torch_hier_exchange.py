"""The hierarchical exchange (item 10, ``dcn_sharding=True``,
docs/design.md §20) on four spawned gloo ranks (a 2 x 2 ``(dcn, data)``
mesh) against the port's two-axis flat twin and the JAX package's
hierarchical layer on ``create_mesh((2, 2))``: the counterparts of JAX's
``tests/test_hierarchical_exchange.py``.

The fuzz draws are JAX's own (``_draw_tables``, ``_draw_hot_sets``,
``_draw_inputs`` from ``default_rng(7000 + seed)``; seeds 0 and 1 in
tier-1, 2 (int8) and 3 (hot sets, 3 chunks) ``slow``, as JAX marks
them), on 2 x 2 instead of JAX's 2 x 4.  The weights are those of JAX's
flat layer drawn from ``PRNGKey(seed)``; they reach both packages'
hierarchical layers through ``set_weights`` of the flat twin and
``hierarchical_params``.  For each draw (``torch_exchange_worker.hier``):

- bit for bit inside the port: the hierarchical init against the flat
  init resharded, the forward, the two steps' losses, and the trained
  hierarchical rows against the trained-then-resharded flat ones;
- against JAX: ``hierarchical_params`` on every real row bit for bit,
  the forward's recorded legs (``dcn/ids``, ``dcn/rows`` on the ``dcn``
  axis), the forward at the rank tests' bounds (bit-exact at hotness 1,
  1e-6 above), the losses and the trained rows at the rank tests'
  bounds (tables rtol 2e-4 / atol 2e-6, accumulators 5e-3 / 5e-4);
- the exchange program: its ICI-only twin (``dcn_leg=False``) ships
  exactly the flat layer's program.

The counters (``measure_exchange_counters``: ``0 < dcn_rows <
dcn_rows_off``, the per-slice bound taken from the inputs, a flat
layer's DCN lane idle), the checkpoint refusals and the refusal matrix
are host-side and run on cell (0, 0) of a mesh without process groups.
"""

import dataclasses
import pickle

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.parallel import (SparseAdagrad, SparseSGD,
                                                 TableConfig, get_weights,
                                                 init_hybrid_train_state,
                                                 make_hybrid_train_step,
                                                 set_weights)
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import hotcache as jax_hotcache
from distributed_embeddings_tpu.parallel import quantization as jq
from distributed_embeddings_tpu.parallel.dist_embedding import (
    hierarchical_params as jax_hierarchical_params)
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import hotcache
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import (
    TableConfig as PortTableConfig)

import test_hierarchical_exchange as jax_hier_tests
import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

GB = jax_hier_tests.GB
SHAPE = (2, 2)
STEPS = 2
RANK_TIMEOUT = 240


def _jax_mesh():
  return torch_parity.jax_mesh(4, slices=2)


def _draw(seed):
  """JAX's ``test_fuzz_hier_parity`` draw of ``seed`` (the same rng calls
  in the same order), its layers on 2 x 2, the flat layer's drawn
  weights and the hierarchical params made from them."""
  rng = np.random.default_rng(7000 + seed)
  configs, hots = jax_hier_tests._draw_tables(rng)
  kw = {}
  if seed == 1:
    kw['hot_cache'] = jax_hier_tests._draw_hot_sets(rng, configs)
  if seed == 2:
    kw['table_dtype'] = 'int8'
  if seed == 3:
    kw['hot_cache'] = jax_hier_tests._draw_hot_sets(rng, configs)
    kw['overlap_chunks'] = 3
  flat = JaxDistributedEmbedding(configs, mesh=_jax_mesh(),
                                 packed_storage=False, **kw)
  weights = get_weights(flat, flat.init(jax.random.PRNGKey(seed)))
  weights = [np.asarray(w.values() if hasattr(w, 'values') else w,
                        np.float32) for w in weights]
  ins = jax_hier_tests._draw_inputs(rng, configs, hots)
  W = [np.asarray(jax.random.normal(jax.random.PRNGKey(90 + i), (w,)),
                  np.float32)
       for i, w in enumerate(c.output_dim for c in configs)]
  steps = [jax_hier_tests._draw_inputs(rng, configs, hots)
           for _ in range(STEPS)]
  hot = kw.get('hot_cache')
  return {
      'seed': seed, 'batch': GB, 'weights': weights, 'ins': ins, 'W': W,
      'steps': steps, 'opt': 'sgd' if seed % 2 == 0 else 'adagrad',
      'tables': [(c.input_dim, c.output_dim, c.combiner) for c in configs],
      'hot': None if hot is None else {t: h.ids for t, h in hot.items()},
      'options': {k: v for k, v in kw.items() if k != 'hot_cache'},
      'jax_options': kw}


def _jax(draw):
  """JAX's hierarchical layer from the draw's weights: its params, the
  forward and its legs, two hybrid steps' losses and trained leaves."""
  configs = [TableConfig(*t) for t in draw['tables']]
  kw = draw['jax_options']
  flat = JaxDistributedEmbedding(configs, mesh=_jax_mesh(),
                                 packed_storage=False, **kw)
  hier = JaxDistributedEmbedding(configs, mesh=_jax_mesh(),
                                 dcn_sharding=True, **kw)
  params = jax_hierarchical_params(hier, set_weights(flat, draw['weights']))
  jins = [jnp.asarray(x) for x in draw['ins']]
  outs = [np.asarray(o) for o in hier.apply(params, jins)]
  legs = [l.as_dict() for l in hier.lookup_plan(global_batch=GB).legs]
  opt = (SparseSGD(learning_rate=0.3) if draw['opt'] == 'sgd'
         else SparseAdagrad(learning_rate=0.3))

  def loss_fn(dense_params, emb_outs, batch):
    return sum(jnp.sum(o * jnp.asarray(wv))
               for o, wv in zip(emb_outs, draw['W'])) / GB

  state = init_hybrid_train_state(hier, {'embedding': dict(params)},
                                  optax.sgd(0.1), opt)
  step = make_hybrid_train_step(hier, loss_fn, optax.sgd(0.1), opt,
                                donate=False)
  losses = []
  for ins in draw['steps']:
    state, loss = step(state, [jnp.asarray(x) for x in ins], None)
    losses.append(float(loss))
  host = lambda tree: {k: np.asarray(jax.device_get(v))
                       for k, v in tree.items()}
  return {'params': host(params), 'outs': outs, 'legs': legs,
          'losses': losses, 'trained': host(state.params['embedding']),
          'state': {f'{k}/{leaf}': np.asarray(jax.device_get(v))
                    for k, st in state.opt_state[1].items()
                    for leaf, v in st.items()},
          'hier': hier}


def _cell(leaf, key, s, d, hier):
  """Cell ``(s, d)``'s real rows of a JAX hierarchical leaf (hot leaves
  are replicated: the whole buffer)."""
  if key.split('/')[0].startswith('hot_'):
    return leaf
  gi = int(key.split('/')[0].rsplit('_', 1)[1])
  n = hier.hier.groups[gi].rows_h[s][d]
  return leaf[s * hier.world_size + d, :n]


@pytest.mark.parametrize('seed', [
    0,
    1,
    pytest.param(2, marks=pytest.mark.slow),
    pytest.param(3, marks=pytest.mark.slow),
])
def test_fuzz_hier_parity(seed, tmp_path):
  draw = _draw(seed)
  case = {'shape': SHAPE, 'draws': {'d': draw}}
  torch_parity.spawn_ranks(torch_exchange_worker.hier, case, tmp_path,
                           world_size=4, timeout=RANK_TIMEOUT)
  got = []
  for r in range(4):
    with open(tmp_path / f'hier{r}.pkl', 'rb') as f:
      got.append(pickle.load(f)['d'])
  want = _jax(draw)
  hier = want['hier']
  quant = 'table_dtype' in draw['options']
  hotness = [1 if x.ndim == 1 else x.shape[1] for x in draw['ins']]
  b = GB // 4
  for r, g in enumerate(got):
    s, d = divmod(r, 2)
    ctx = f'seed {seed} rank {r}'
    # inside the port: the hier layer is the flat layer, bit for bit
    for a, c in zip(g['outs'], g['flat_outs']):
      np.testing.assert_array_equal(a, c, err_msg=ctx)
    assert g['hier_losses'] == g['flat_losses'], ctx
    assert sorted(g['trained']) == sorted(g['trained_flat'])
    for k in g['trained']:
      np.testing.assert_array_equal(g['trained'][k], g['trained_flat'][k],
                                    err_msg=f'{ctx} trained {k}')
    # against JAX: the converted params exactly, then the run
    assert sorted(g['converted']) == sorted(want['params'])
    for k, v in g['converted'].items():
      np.testing.assert_array_equal(
          v, _cell(want['params'][k], k, s, d, hier),
          err_msg=f'{ctx} hierarchical_params {k}')
    assert g['legs'] == want['legs'], ctx
    assert [l['axis'] for l in g['legs'] if l['name'].startswith('dcn/')
            ] == ['dcn', 'dcn'], g['legs']
    torch_parity.assert_outputs_match(
        [torch.as_tensor(o) for o in g['outs']],
        [o[r * b:(r + 1) * b] for o in want['outs']], hotness)
    np.testing.assert_allclose(g['hier_losses'], want['losses'], rtol=2e-4,
                               atol=2e-6, err_msg=ctx)
    for k, v in g['trained'].items():
      w = _cell(want['trained'][k], k, s, d, hier)
      if quant and not k.startswith('scale') and 'scale' not in k:
        # int8 payloads: dequantized, within one grid step a step
        scale_k = k.replace('group_', 'scale_group_')
        sv = g['trained'][scale_k]
        sw = _cell(want['trained'][scale_k], scale_k, s, d, hier)
        diff = np.abs(jq.dequantize_np(v, sv) - jq.dequantize_np(w, sw))
        assert np.all(diff <= STEPS * np.maximum(sv, sw)), (ctx, k)
      elif not quant:
        np.testing.assert_allclose(v, w, rtol=2e-4, atol=2e-6,
                                   err_msg=f'{ctx} trained {k}')
    for k, v in g['state'].items():
      np.testing.assert_allclose(v, _cell(want['state'][k], k, s, d, hier),
                                 rtol=5e-3, atol=5e-4,
                                 err_msg=f'{ctx} state {k}')
    # the exchange program: its intra-slice twin is the flat layer's
    prog = g['program']
    assert prog['ici_only'] == prog['flat'], (ctx, prog)
    assert np.isfinite(prog['hier']) and prog['hier'] != prog['ici_only']


@dataclasses.dataclass(frozen=True)
class _Cell:
  """Cell (0, 0) of a 2 x 2 mesh without process groups: enough for the
  plan, the hierarchical layout and the host-side checks below."""
  device: torch.device = torch.device('cpu')
  group: object = None
  dcn_group: object = None
  shape: tuple = SHAPE
  world_size: int = 2
  rank: int = 0
  num_slices: int = 2
  slice_index: int = 0
  product_size: int = 4
  product_rank: int = 0


COUNTER_TABLES = [(10, 4, 'sum'), (12, 4, 'mean'), (8, 8, None),
                  (14, 4, 'sum')]
COUNTER_HOTS = [3, 4, 1, 3]

_COUNTER_KEYS = ('dcn_rows', 'dcn_rows_off', 'dcn_dedup_ratio',
                 'dcn_rows_per_slice', 'dcn_rows_off_per_slice', 'ici_rows',
                 'alltoall_rows_sent', 'alltoall_rows_sent_off',
                 'scatter_rows_per_step', 'total_id_occurrences')


def test_dcn_crosses_once_counters():
  """JAX's ``test_dcn_crosses_once_counters`` at 2 x 2: each distinct row
  crosses DCN at most once per source slice (``dcn_rows_per_slice[s]``
  bounded by the distinct ids slice ``s``'s block requests), the dedup
  wins (``0 < dcn_rows < dcn_rows_off``), a flat layer's DCN lane is
  idle, and every counter equals JAX's on the same ids."""
  rng = np.random.default_rng(42)
  configs = [TableConfig(*t) for t in COUNTER_TABLES]
  cats = jax_hier_tests._draw_inputs(rng, configs, COUNTER_HOTS, pad=False)
  ports = [PortTableConfig(*t) for t in COUNTER_TABLES]
  for dcn in (False, True):
    mine = hotcache.measure_exchange_counters(
        DistributedEmbedding(ports, mesh=_Cell(), dcn_sharding=dcn), cats)
    theirs = jax_hotcache.measure_exchange_counters(
        JaxDistributedEmbedding(configs, mesh=_jax_mesh(),
                                packed_storage=False, dcn_sharding=dcn),
        cats)
    assert {k: mine[k] for k in _COUNTER_KEYS} == {
        k: theirs[k] for k in _COUNTER_KEYS}, dcn
    assert mine['ici_rows'] == mine['alltoall_rows_sent']
    if not dcn:
      assert mine['dcn_rows'] == mine['dcn_rows_off'] == 0
      assert mine['dcn_dedup_ratio'] == 1.0
      continue
    per, per_off = mine['dcn_rows_per_slice'], mine['dcn_rows_off_per_slice']
    assert len(per) == len(per_off) == SHAPE[0]
    assert mine['dcn_rows'] == sum(per)
    assert mine['dcn_rows_off'] == sum(per_off)
    assert 0 < mine['dcn_rows'] < mine['dcn_rows_off']
    assert mine['dcn_dedup_ratio'] == round(
        mine['dcn_rows_off'] / mine['dcn_rows'], 4) > 1.0
    slice_batch = GB // SHAPE[0]
    for s in range(SHAPE[0]):
      bound = 0
      for x in cats:
        blk = x[s * slice_batch:(s + 1) * slice_batch]
        bound += int(np.unique(blk[blk >= 0]).size)
      assert per[s] <= bound, (s, per[s], bound)
      assert per[s] <= per_off[s]


def test_checkpoint_refuses_hier():
  """Every checkpoint entry point refuses a hierarchical layer before
  any file I/O, naming the flat-twin route, with JAX's message."""
  configs = [(24, 4, 'sum'), (16, 4, 'mean')]
  hier = DistributedEmbedding([PortTableConfig(*t) for t in configs],
                              mesh=_Cell(), dcn_sharding=True)
  jhier = JaxDistributedEmbedding([TableConfig(*t) for t in configs],
                                  mesh=_jax_mesh(), dcn_sharding=True)
  params = hier.init(0)
  weights = [np.zeros((r, w), np.float32) for r, w, _ in configs]
  calls = [
      ('set_weights', lambda m, d: m.set_weights(d, weights)),
      ('get_weights', lambda m, d: m.get_weights(d, params)),
      ('get_optimizer_state', lambda m, d: m.get_optimizer_state(d, {})),
      ('set_optimizer_state', lambda m, d: m.set_optimizer_state(
          d, {}, [{} for _ in configs])),
      ('restore_train_state', lambda m, d: m.restore_train_state(
          d, None, '/nonexistent')),
  ]
  for name, call in calls:
    with pytest.raises(NotImplementedError,
                       match='hierarchical_params') as got:
      call(checkpoint, hier)
    assert 'dcn_sharding' in str(got.value) and name in str(got.value)
    with pytest.raises(NotImplementedError) as want:
      call(jax_ckpt, jhier)
    assert str(got.value) == str(want.value), name


@pytest.mark.parametrize('kw,flat', [
    (dict(dcn_sharding=True), True),
    (dict(dcn_sharding=True, dp_input=False), False),
    (dict(dcn_sharding=True, row_slice=400), False),
    (dict(cold_tier=True, hot_cache='set'), False),
])
def test_refusal_matrix_like_jax(kw, flat):
  """The hierarchical placement's refusals (and the cold tier's on a
  two-axis mesh) word for word as JAX's."""
  kw = dict(kw)
  if kw.get('hot_cache') == 'set':
    kw['hot_cache'] = {0: jax_hotcache.HotSet(0, np.array([1, 2]))}
  tables = [(40, 8, 'sum'), (30, 4, 'sum')]
  with pytest.raises(ValueError) as want:
    JaxDistributedEmbedding(
        [TableConfig(*t) for t in tables],
        mesh=torch_parity.jax_mesh(4) if flat else _jax_mesh(), **kw)
  if 'hot_cache' in kw:
    kw['hot_cache'] = {0: hotcache.HotSet(0, np.array([1, 2]))}
  with pytest.raises(ValueError) as got:
    DistributedEmbedding([PortTableConfig(*t) for t in tables],
                         **(dict(device='cpu') if flat
                            else dict(mesh=_Cell())), **kw)
  assert str(got.value) == str(want.value)
