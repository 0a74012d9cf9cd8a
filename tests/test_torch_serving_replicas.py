"""Serving replicas on disjoint rank sets (``mesh.create_mesh(ranks=)``,
``serving.replica_front_ends``): one ``ServingEnginePool`` on rank 0, the
front door, over replicas that each own their ranks, on spawned gloo
ranks (CPU), against the JAX package's ``ServingEnginePool`` over engines
on the matching disjoint CPU sub-meshes, over the reduced tiny model of
tests/test_torch_serving_ranks.py (hotness-1 and hotness-10 inputs,
serving hot sets); the ranks run ``tests/torch_exchange_worker.py``.

- Two layouts: ``[0, 1] + [2, 3]`` (world 4, the front door in replica
  0) and ``[0] + [1, 2]`` (world 3: a world-of-one engine on rank 0 beside
  a replica whose ranks are all remote, the front door outside it); the
  first also with a cold tier on every engine (its collectives on the
  groups each replica's mesh made for them).
  Every answer alone through each replica, batched on each, through the
  pool and in the overload arm equals JAX's pool's: bit-equal at hotness
  1, rtol = atol = 1e-6 above (the JAX engine's bound).  Both replicas
  run on the ladder of the larger one.
- The overload arm (``measure_overload``, replica 0 quarantined half-way)
  resolves every future; the pool's stats carry one front-end block a
  replica; the drill on the remote replica (``fail_replica``) closes its
  link, so its followers return their counts and exit 0.
- A follower of replica 1 raises mid-burst: only replica 1 is
  quarantined, replica 0's link reports ``lost: false``, every accepted
  future resolves served or shed, the retried answers bit-equal
  ``lookup_padded`` on replica 0, replica 1's ranks end with
  ``FOLLOWER_FAULT_EXIT`` and every process ends within the test's
  timeout.
"""

import json
import multiprocessing
import pickle
import time

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu import serving as jax_serving
from distributed_embeddings_tpu.parallel import TableConfig as JaxTableConfig
from distributed_embeddings_tpu.parallel.hotcache import HotSet as JaxHotSet
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.serving import frontend
from distributed_embeddings_tpu_torch.serving.engine import (
    default_bucket_ladder)

import test_torch_serving_ranks as ranks_case
import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

LAYOUTS = {'2x2': [[0, 1], [2, 3]], '1+2': [[0], [1, 2]],
           '2x2-cold': [[0, 1], [2, 3]]}
OVERLOAD_SIZES = (1, 2, 4, 3, 8, 1, 5, 2, 6, 1, 7, 3)
FAULT_TIMEOUT_S = 20.0  # the front door's control-group timeout
FAULT_WAIT_S = 120.0  # every rank of the fault case ends within this


def _case(layout, seed, cold=False):
  """tests/test_torch_serving_ranks.py's case on ``layout``, the ladder of
  the largest replica for every replica, and the overload arm's
  requests; ``cold``: every engine with a cold tier, a device budget of
  0.3 of a rank's resident tables (the larger groups go to the host)."""
  case = ranks_case._case(seed=seed)
  largest = max(len(r) for r in layout)
  extra = ranks_case._case(seed=seed + 100)['requests']
  rng = np.random.default_rng(seed)
  overload = [[np.asarray(c)[:n] for c in extra[int(rng.integers(2, 5))]]
              for n in OVERLOAD_SIZES]
  case = dict(case, layout=layout, overload=overload,
              buckets=list(default_bucket_ladder(case['batch'], largest)))
  if cold:
    resident = DistributedEmbedding(
        [TableConfig(*t) for t in case['tables']], device='cpu',
        dp_input=True, input_table_map=case['itm'],
        hot_cache={t: HotSet(t, np.asarray(i))
                   for t, i in case['hot'].items()}
    ).plan.resident_table_bytes()
    case['cold_budget'] = int(resident * 0.3 / largest)
  return case


def _jax_engine(case, ranks):
  return jax_serving.ServingEngine(
      [JaxTableConfig(*t) for t in case['tables']], case['weights'],
      mesh=torch_parity.jax_mesh(len(ranks), start=ranks[0]),
      batch_size=case['batch'], buckets=case['buckets'],
      input_table_map=case['itm'], hotness=case['hotness'],
      hot_sets={t: JaxHotSet(t, np.asarray(i))
                for t, i in case['hot'].items()},
      cold_tier=case.get('cold_budget') is not None,
      device_hbm_budget=case.get('cold_budget'))


def _jax_pool_answers(case, requests):
  """JAX's ``ServingEnginePool`` over engines on the layout's disjoint
  CPU sub-meshes: every request's answers."""
  engines = [_jax_engine(case, r) for r in case['layout']]
  with jax_serving.ServingEnginePool(engines, max_delay_ms=5.0) as pool:
    futs = [pool.submit(r) for r in requests]
    return [[np.asarray(a) for a in f.result(timeout=300.0)] for f in futs]


def _like_jax(got, prefix, want, hotness):
  n_in = len(hotness)
  for j, w in enumerate(want):
    ranks_case._assert_like_jax([got[f'{prefix}_{j}_{k}']
                                 for k in range(n_in)], w, hotness,
                                f'{prefix} request {j}')


@pytest.mark.parametrize('name', list(LAYOUTS))
def test_disjoint_replicas_against_jax_pool(name, tmp_path):
  layout = LAYOUTS[name]
  world = sum(len(r) for r in layout)
  case = _case(layout, seed=3 + world, cold=name.endswith('cold'))
  torch_parity.spawn_ranks(torch_exchange_worker.serve_replicas, case,
                           tmp_path, world_size=world)
  want = _jax_pool_answers(case, case['requests'] + case['overload'])
  n = len(case['requests'])
  want_req, want_over = want[:n], want[n:]
  res = [json.loads((tmp_path / f'replicas{r}.json').read_text())
         for r in range(world)]
  lead = res[0]
  with np.load(tmp_path / 'replicas0.npz') as z:
    got = dict(z)
  hot = case['hotness']
  # the cold tier on a replica's ranks runs on its mesh's host groups
  assert bool(lead['cold_groups']) == ('cold_budget' in case)
  assert [m.split(':')[0] for m in lead['refused']] == (
      ['ValueError'] * (4 if 'cold_budget' in case else 3))
  if 'cold_budget' in case:
    assert 'a second layer with a cold tier' in lead['refused'][3]
  assert 'distinct ranks' in lead['refused'][0]
  assert 'disjoint' in lead['refused'][1]
  assert 'replica_front_ends' in lead['refused'][2]
  for i in range(len(layout)):
    _like_jax(got, f'lone{i}', want_req, hot)
    _like_jax(got, f'batch{i}', want_req, hot)
  _like_jax(got, 'pool', want_req, hot)
  # the pool's stats: a front-end block a replica with a link (none for
  # a world-of-one engine on the front door), each over its own ranks
  blocks = lead['pool_stats']['front_end']
  assert len(blocks) == len(layout)
  for block, ranks in zip(blocks, layout):
    if ranks == [0]:
      assert block is None
    else:
      assert block['ranks'] == ranks and block['world_size'] == len(ranks)
      assert block['replicas'] == 1 and not block['lost']
  assert lead['pool_stats']['completed'] == n
  # the overload arm: replica 0 quarantined half-way, every future
  # resolved served or shed, every served answer JAX's; the other links
  # untouched
  over = lead['overload']
  outcomes = lead['over_outcomes']
  assert len(outcomes) == len(case['overload'])
  assert set(outcomes) <= {None, 'RequestSheddedError'}, outcomes
  assert over['serve_over_quarantined'] == 1
  assert over['serve_over_served'] == outcomes.count(None) > 0
  assert over['serve_over_served'] + over['serve_over_shed'] == len(outcomes)
  for j, w in enumerate(want_over):
    if outcomes[j] is None:
      ranks_case._assert_like_jax([got[f'over_{j}_{k}']
                                   for k in range(len(hot))], w, hot,
                                  f'overload request {j}')
  links = lead['over_links']
  assert links[-1] is not None and not links[-1]['lost']
  # the drill on the remote replica: its link closed, not lost; its
  # followers returned their counts (spawn_ranks checked every exit 0)
  assert lead['drill_closed'] and not lead['drill_link']['lost']
  for ranks, link in zip(layout, lead['links']):
    if link is None:
      continue
    assert not link['lost']
    for r in ranks:
      if r == 0:
        continue
      assert res[r]['counts']['batches'] == link['batches'], (r, res[r])
      assert res[r]['replica'] == layout.index(ranks)
      assert res[r]['engine_batches'] == link['batches']


def _spawn_fault(case, tmp_path, world):
  """The ranks of ``serve_replicas_fault``; waits at most
  ``FAULT_WAIT_S`` and reaps what is left.  Returns the exit codes, the
  ranks still alive at the deadline and the log tails."""
  case_path = tmp_path / 'case.pkl'
  with open(case_path, 'wb') as f:
    pickle.dump(case, f)
  ctx = multiprocessing.get_context('spawn')
  init = f'file://{tmp_path / "rendezvous"}'
  procs = [ctx.Process(target=torch_exchange_worker.rank_main,
                       args=(torch_exchange_worker.serve_replicas_fault, r,
                             world, init, str(case_path), str(tmp_path)))
           for r in range(world)]
  for p in procs:
    p.start()
  deadline = time.monotonic() + FAULT_WAIT_S
  while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
    time.sleep(0.05)
  hung = [r for r, p in enumerate(procs) if p.is_alive()]
  for p in procs:
    if p.is_alive():
      p.kill()
      p.join(timeout=10)
  logs = [torch_parity._log_tail(tmp_path / f'rank{r}.log')
          for r in range(world)]
  return [p.exitcode for p in procs], hung, logs


def test_follower_fault_costs_only_its_replica(tmp_path):
  """Rank 3 (replica 1) raises mid-burst: it and rank 2 end with
  ``FOLLOWER_FAULT_EXIT``; the front door quarantines replica 1 alone,
  every future resolves served or shed, the retried answers bit-equal
  ``lookup_padded`` on replica 0, whose link stays up until its ``stop``
  returns rank 1's counts."""
  layout = LAYOUTS['2x2']
  case = _case(layout, seed=11)
  # its engine's second batch of the burst (after the warm-up's rungs)
  case.update(timeout=FAULT_TIMEOUT_S, burst=case['overload'] * 3,
              fault_at=len(case['buckets']) + 2)
  codes, hung, logs = _spawn_fault(case, tmp_path, 4)
  fault = frontend.FOLLOWER_FAULT_EXIT
  assert not hung and codes == [0, 0, fault, fault], (codes, hung, logs)
  assert 'injected follower fault in replica 1' in logs[3]
  assert 'follower rank 2 failed' in logs[2]
  out = json.loads((tmp_path / 'fault0.json').read_text())
  st = out['pool_stats']
  assert st['quarantined'] == 1 and st['live_replicas'] == 1
  assert st['completed'] == len(case['burst'])
  assert set(out['outcomes']) <= {'served', 'RequestSheddedError'}
  assert out['outcomes'].count('served') > 0
  assert max(out['retried']) >= 1
  assert out['retried_bit_equal'] and all(out['retried_bit_equal'])
  assert out['resolve_s'] < FAULT_WAIT_S / 2
  assert [b['lost'] for b in st['front_end']] == [False, True]
  assert [b['lost'] for b in out['links']] == [False, True]
  follower = json.loads((tmp_path / 'fault1.json').read_text())
  assert follower['counts']['batches'] == out['links'][0]['batches']
  assert not (tmp_path / 'done2').exists()
  assert not (tmp_path / 'done3').exists()
