"""The port's multi-rank exchange on the CPU: two spawned gloo ranks run
``DistributedEmbedding.apply`` (world size 2) and each must equal its
slice of the JAX package's forward on a 2-device CPU mesh, for plans
that column-slice and row-slice tables: bit-exact at hotness 1, rtol =
atol = 1e-6 above (XLA may add a sample's rows in another order than
the port's ascending sum).  The exchange itself moves values without
arithmetic: without row slicing (where shard partials add) each rank's
output equals the port's own world-of-one forward bit for bit.  The
recorded exchange legs equal the JAX LookupPlan's, fused ones and the
per-buffer leg of a phase with a single live buffer."""

import json
import multiprocessing
import pickle
import socket

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)

from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

import torch_exchange_worker
import torch_parity

TABLES = [(64, 16, 'sum'), (100, 8, 'mean'), (50, 8, None),
          (300, 16, 'sum'), (30, 4, 'sum')]
INPUT_TABLE_MAP = [0, 1, 2, 3, 4, 0, 3]
HOTNESS = [1, 4, 1, 3, 2, 2, 1]
BATCH = 16


def _free_port():
  with socket.socket() as s:
    s.bind(('localhost', 0))
    return s.getsockname()[1]


def _case(options):
  """The inputs of one parity case; ``one_subgroup`` keeps only the
  hotness-1 inputs of the width-16 sum tables, so each exchange phase
  has a single live buffer (the per-buffer leg)."""
  options = dict(options)
  itm, hot = INPUT_TABLE_MAP, HOTNESS
  if options.pop('one_subgroup', False):
    itm, hot = [0, 3, 3], [1, 1, 1]
  rng = np.random.default_rng(11)
  weights = [rng.normal(size=(r, w)).astype(np.float32)
             for r, w, _ in TABLES]
  cats = [rng.integers(0, TABLES[t][0], size=(BATCH, h)).astype(np.int32)
          for t, h in zip(itm, hot)]
  cats = torch_parity.padded_cats(cats, hot, seed=11,
                                  vocabs=[TABLES[t][0] for t in itm])
  return {'tables': TABLES, 'weights': weights, 'cats': cats,
          'batch': BATCH, 'hotness': hot,
          'options': dict(input_table_map=itm,
                          strategy='memory_balanced', **options)}


def _jax_forward(case):
  opts = dict(case['options'])
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(r, w, combiner=c) for r, w, c in TABLES],
      mesh=torch_parity.jax_mesh(2), **opts)
  outs = jd.apply(jax_ckpt.set_weights(jd, case['weights']), case['cats'])
  return jd, [np.asarray(o) for o in outs]


def _run_ranks(case, tmp_path, world_size=2):
  case_path = tmp_path / 'case.pkl'
  with open(case_path, 'wb') as f:
    pickle.dump(case, f)
  ctx = multiprocessing.get_context('spawn')
  init = f'tcp://localhost:{_free_port()}'
  procs = [ctx.Process(target=torch_exchange_worker.run,
                       args=(r, world_size, init, str(case_path),
                             str(tmp_path)))
           for r in range(world_size)]
  for p in procs:
    p.start()
  for p in procs:
    p.join(timeout=240)
  alive = [p for p in procs if p.is_alive()]
  for p in alive:
    p.kill()
    p.join(timeout=10)
  assert not alive, 'a rank hung'
  assert [p.exitcode for p in procs] == [0] * world_size
  ranks = []
  for r in range(world_size):
    with np.load(tmp_path / f'rank{r}.npz') as z:
      outs = [z[f'arr_{i}'] for i in range(len(z.files))]
    with np.load(tmp_path / f'weights{r}.npz') as z:
      weights = [z[f'arr_{i}'] for i in range(len(z.files))]
    with open(tmp_path / f'legs{r}.json') as f:
      legs = json.load(f)
    ranks.append((outs, weights, legs))
  return ranks


def _rank_slice(outs, rank):
  b = BATCH // 2
  return [o[rank * b:(rank + 1) * b] for o in outs]


def _port_world_of_one(case):
  dist = DistributedEmbedding(
      [TableConfig(r, w, combiner=c) for r, w, c in TABLES], device='cpu',
      **case['options'])
  params = checkpoint.set_weights(dist, case['weights'])
  return [o.numpy() for o in dist.apply(params, case['cats'])]


@pytest.mark.parametrize('options', [
    dict(column_slice_threshold=500),
    dict(row_slice=700),
    dict(column_slice_threshold=500, one_subgroup=True),
], ids=['column_slice', 'row_slice', 'one_subgroup'])
def test_two_ranks_match_jax(options, tmp_path):
  case = _case(options)
  jd, want = _jax_forward(case)
  plan = jd.plan
  if 'row_slice' in options:
    assert any(plan.row_sliced)
  else:
    assert any(len(reqs) > 1 for reqs in plan.input_requests)
  ranks = _run_ranks(case, tmp_path)
  single = _port_world_of_one(case)
  jax_legs = [l.as_dict() for l in jd.lookup_plan(global_batch=BATCH).legs]
  for rank, (outs, weights, legs) in enumerate(ranks):
    torch_parity.assert_outputs_match(
        [torch.as_tensor(o) for o in outs], _rank_slice(want, rank),
        case['hotness'])
    if 'row_slice' not in options:
      for i, (o, s) in enumerate(zip(outs, _rank_slice(single, rank))):
        np.testing.assert_array_equal(o, s, err_msg=f'rank {rank} in {i}')
    assert legs == jax_legs
    for got, w in zip(weights, case['weights']):
      np.testing.assert_array_equal(got, w)
  want_names = (['fwd/ids/g0', 'fwd/rows/g0'] if 'one_subgroup' in options
                else ['fwd/ids', 'fwd/rows'])
  assert [l['name'] for l in ranks[0][2]] == want_names
