"""The multi-rank serving front end (``serving.RankFrontEnd``) on 2 and 4
spawned gloo ranks (CPU), against the JAX package's ``DynamicBatcher``
over a JAX ``ServingEngine`` on a CPU mesh of the same device count,
over a reduced tiny model (hotness-1 and hotness-10 inputs, serving hot
sets); the ranks run ``tests/torch_exchange_worker.py``.

- The leader's answers through ``lookup_padded``, the pipelined and the
  serial batcher (ladder and monolithic) and a two-replica pool (replica
  0 failed half-way, then a degraded-mode batch) equal JAX's batcher's:
  bit-equal at hotness 1, rtol = atol = 1e-6 above (the JAX engine's
  bound); the degraded answers equal JAX's on its ``hot_only_filter``.
- Every follower ran as many batches as the leader sent, per replica,
  and waited on while the leader idled past its own control-group
  timeout; ``stop`` reaches every rank and ``close`` is idempotent.
- Refusals: a bare engine of several ranks (batcher, pool), a follower's
  front end (batcher, pool, lookup), a malformed request (refused on the
  leader, nothing sent).  What refused before replicas on disjoint rank
  sets were ported now serves, its answers JAX's: on four ranks two
  replicas on the world's halves (a link each), and a pool over the front
  end beside a world-of-one engine on the leader's card.
- A follower whose lookup raises ends its process non-zero, and the
  leader's futures fail with ``ReplicaLostError`` within the control
  group's timeout; the leader closes without hanging (a spawn of its
  own, which checks the exit codes).  A fault in the leader's own block
  after the broadcast fails its futures the same way, and the follower
  left waiting on the control group ends at once, non-zero.
- The port's ``serve.py`` on two gloo ranks: the leader's JSON has the
  world-of-one run's keys, every batched and served overload answer
  equals a numpy gather of the bundle's rows, and the leader's trace
  passes the port's report with ``--strict``.
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
from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
from distributed_embeddings_tpu_torch.examples.dlrm import serve as dlrm_serve
from distributed_embeddings_tpu_torch.models import synthetic
from distributed_embeddings_tpu_torch.serving import frontend
from distributed_embeddings_tpu_torch.serving.engine import (
    default_bucket_ladder)
from distributed_embeddings_tpu_torch.tools import trace_report

import torch_exchange_worker
import torch_parity

torch.set_num_threads(1)

BATCH = 16
SIZES = (0, 1, 5, 8, 16, 1, 3, 2, 7)  # empty, one, a few, a rung, the batch
TIMEOUT_S = 20.0
IDLE_TIMEOUT_S = 5.0  # the leader's control-group timeout in the idle case
LINGER_S = 3.0  # the faulted leader's process stays up this long
ARMS = ('lone', 'pipe_ladder', 'serial_ladder', 'serial_mono', 'pipe_mono',
        'pool')


def _case(seed=0):
  """The reduced tiny model (one table a block: 9 tables, 12 inputs of
  hotness 1 and 10), its weights, hot sets on the larger tables, the
  requests (``SIZES``) and three low requests for the degraded batch."""
  cfg = torch_parity.reduced(synthetic, 'tiny', max_rows=600, max_tables=1)
  tables, itm, hotness = synthetic.expand_tables(cfg)
  rng = np.random.default_rng(seed)
  weights = [rng.normal(size=(t.input_dim, t.output_dim)).astype(np.float32)
             for t in tables]
  hot = {t: list(range(0, min(40, c.input_dim), 3))
         for t, c in enumerate(tables) if c.input_dim >= 100}
  vocabs = [tables[t].input_dim for t in itm]

  def request(n):
    # multi-hot rows keep a random prefix of 1..h ids, -1 after it
    cats = []
    for v, h in zip(vocabs, hotness):
      c = rng.integers(0, v, size=(n, h)).astype(np.int32)
      if h > 1:
        keep = rng.integers(1, h + 1, size=(n, 1))
        c[np.arange(h)[None, :] >= keep] = -1
      cats.append(c[:, 0] if h == 1 else c)
    return cats

  return {
      'tables': [(t.input_dim, t.output_dim, t.combiner) for t in tables],
      'itm': list(itm), 'hotness': list(hotness), 'weights': weights,
      'hot': hot, 'batch': BATCH, 'timeout': TIMEOUT_S,
      'idle_timeout': IDLE_TIMEOUT_S,
      'requests': [request(n) for n in SIZES],
      'degraded': [request(4) for _ in range(3)],
  }


def _jax_answers(case, world):
  """JAX's ``DynamicBatcher`` over a JAX engine on a ``world``-device CPU
  mesh: every request's answers, and the low requests' (the degraded
  ones' on the engine's ``hot_only_filter``)."""
  engine = jax_serving.ServingEngine(
      [JaxTableConfig(*t) for t in case['tables']], case['weights'],
      mesh=torch_parity.jax_mesh(world), batch_size=case['batch'],
      input_table_map=case['itm'], hotness=case['hotness'],
      hot_sets={t: JaxHotSet(t, np.asarray(i))
                for t, i in case['hot'].items()})
  # the first low request comes at pressure 1 and is served whole, the
  # next two at 2 and 3, the pool's degraded mode
  lows = case['degraded']
  filtered = lows[:1] + [engine.hot_only_filter(r)[0] for r in lows[1:]]
  with jax_serving.DynamicBatcher(engine, max_delay_ms=5.0) as bat:
    futs = [bat.submit(r) for r in case['requests'] + filtered]
    outs = [[np.asarray(a) for a in f.result(timeout=300.0)] for f in futs]
  n = len(case['requests'])
  return outs[:n], outs[n:]


def _assert_like_jax(got, want, hotness, what):
  assert len(got) == len(want), what
  for i, (g, w, h) in enumerate(zip(got, want, hotness)):
    assert g.dtype == np.float32 and g.shape == w.shape, (what, i)
    if h == 1:
      np.testing.assert_array_equal(g, w, err_msg=f'{what} input {i}')
    else:
      np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                 err_msg=f'{what} input {i}')


@pytest.mark.parametrize('world', [2, 4])
def test_front_end_against_jax_batcher(world, tmp_path):
  case = _case(seed=world)
  torch_parity.spawn_ranks(torch_exchange_worker.serve_ranks, case,
                           tmp_path, world_size=world)
  want, want_degraded = _jax_answers(case, world)
  res = [json.loads((tmp_path / f'serve{r}.json').read_text())
         for r in range(world)]
  lead = res[0]
  with np.load(tmp_path / 'serve0.npz') as z:
    got = dict(z)
  n_in = len(case['hotness'])
  for arm in ARMS:
    for j, w in enumerate(want):
      _assert_like_jax([got[f'{arm}_{j}_{i}'] for i in range(n_in)], w,
                       case['hotness'], f'{arm} request {j}')
  for j, w in enumerate(want_degraded):
    _assert_like_jax([got[f'degraded_{j}_{i}'] for i in range(n_in)], w,
                     case['hotness'], f'degraded request {j}')
  # the pool failed over and degraded as arranged
  pst = lead['pool_stats']
  assert pst['quarantined'] == 1 and pst['live_replicas'] == 1
  assert pst['degraded_served'] == 2 and pst['degraded_enters'] == 1
  assert pst['completed'] == len(SIZES) + 3
  # every rank ran every batch the leader sent, per replica; stop reached
  # every rank (each returned its counts)
  fe = lead['front_end']
  assert fe['world_size'] == world and fe['replicas'] == 2
  assert not fe['lost'] and fe['batches'] == sum(lead['served'])
  assert lead['warm_batches'] == len(default_bucket_ladder(BATCH, world))
  # the leader idled past its own timeout before stop reached every rank
  assert lead['idle_s'] > IDLE_TIMEOUT_S
  for r in res[1:]:
    assert r['counts']['batches'] == fe['batches']
    assert r['counts']['by_replica'] == lead['served'] == r['served']
  # the batchers merged (fewer batches than requests) and the ladder
  # launched below the full batch
  for arm in ('pipe_ladder', 'serial_ladder', 'serial_mono', 'pipe_mono'):
    st = lead[f'{arm}_stats']
    assert st['completed'] == len(SIZES)
    assert 0 < st['batches'] < len(SIZES) - 1, (arm, st['batches'])
  assert set(lead['serial_mono_stats']['bucket_launches']) == {str(BATCH)}
  # refusals, and nothing sent for the malformed and the empty request
  for msg in lead['refused_bare'] + [r['refused_bare'][0] for r in res]:
    assert msg.startswith('ValueError') and 'RankFrontEnd' in msg, msg
  for r in res[1:]:
    assert all(m.startswith('RuntimeError') and 'follower' in m
               for m in r['refused_follower']), r['refused_follower']
  if world == 4:
    # the replicas on the world's halves each answered request 2 as JAX
    # did, over a link of their own, and stop reached their followers
    for i in range(2):
      _assert_like_jax([got[f'disjoint_{i}_{k}'] for k in range(n_in)],
                       want[2], case['hotness'], f'disjoint replica {i}')
    links = lead['disjoint_links']
    assert [link['ranks'] for link in links] == [[0, 1], [2, 3]]
    assert all(link['batches'] == 1 and not link['lost'] for link in links)
    for r in res[1:]:
      assert r['disjoint_counts']['batches'] == 1, r['disjoint_counts']
  # the front end beside a world-of-one engine: one pool, every answer
  # JAX's
  for j, w in enumerate(want):
    _assert_like_jax([got[f'mixed_{j}_{i}'] for i in range(n_in)], w,
                     case['hotness'], f'mixed pool request {j}')
  assert sum(lead['mixed_served']) == len(SIZES)
  assert lead['refused_wide'].startswith('ValueError')
  assert 'hot cap' in lead['refused_wide']
  assert lead['empty_shapes'] == [[0, case['tables'][t][1]]
                                  for t in case['itm']]
  assert lead['sent_for_refused_and_empty'] == 0
  assert lead['refused_closed'].startswith('RuntimeError')
  assert 'closed' in lead['refused_closed']


def _spawn_fault(tmp_path, faulty):
  """The two ranks of ``serve_fault`` with ``faulty`` ('follower' or
  'leader') faulting; waits at most ``6 * TIMEOUT_S``.  Checks the exit
  codes, that no rank hung and that the follower ended while the leader
  lingered; returns the log tails and the leader's ``fault0.json``."""
  case = dict(_case(seed=7), faulty=faulty, linger=LINGER_S)
  case_path = tmp_path / 'case.pkl'
  with open(case_path, 'wb') as f:
    pickle.dump(case, f)
  ctx = multiprocessing.get_context('spawn')
  init = f'file://{tmp_path / "rendezvous"}'
  procs = [ctx.Process(target=torch_exchange_worker.rank_main,
                       args=(torch_exchange_worker.serve_fault, r, 2, init,
                             str(case_path), str(tmp_path)))
           for r in range(2)]
  for p in procs:
    p.start()
  deadline = time.monotonic() + 6 * TIMEOUT_S
  follower_first = False
  while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
    follower_first |= procs[0].is_alive() and not procs[1].is_alive()
    time.sleep(0.02)
  hung = [p.is_alive() for p in procs]
  for p in procs:
    if p.is_alive():
      p.kill()
      p.join(timeout=10)
  logs = [torch_parity._log_tail(tmp_path / f'rank{r}.log')
          for r in range(2)]
  codes = [p.exitcode for p in procs]
  assert not any(hung) and codes == [0, frontend.FOLLOWER_FAULT_EXIT], (
      codes, logs)
  assert follower_first, logs
  assert (tmp_path / 'done0').exists() and not (tmp_path / 'done1').exists()
  out = json.loads((tmp_path / 'fault0.json').read_text())
  assert out['second'].startswith('ReplicaLostError'), out
  assert out['third'].startswith('ReplicaLostError'), out
  assert out['second_s'] < TIMEOUT_S and out['close_s'] < TIMEOUT_S, out
  assert out['lost'] is True
  return logs, out


def test_follower_fault_fails_the_leader_without_a_hang(tmp_path):
  """The follower's second lookup raises: it exits with
  ``FOLLOWER_FAULT_EXIT`` and the error in its log; the leader's second
  and third requests fail with ``ReplicaLostError`` well inside the
  control group's timeout, and it closes and exits 0."""
  logs, _ = _spawn_fault(tmp_path, 'follower')
  assert 'injected follower fault' in logs[1]
  assert 'follower rank 1 failed after 1 batch' in logs[1]


def test_leader_fault_ends_the_followers(tmp_path):
  """The leader's own block raises after the second broadcast: its
  second and third requests fail with ``ReplicaLostError``, it closes
  and exits 0, and the follower, which waits on the control group with
  a timeout of ``FOLLOWER_TIMEOUT_S``, fails at once when the leader
  tears its end down, and exits with ``FOLLOWER_FAULT_EXIT``."""
  logs, out = _spawn_fault(tmp_path, 'leader')
  assert 'injected leader fault' in out['second'], out
  assert 'follower rank 1 failed after' in logs[1]
  assert 'injected' not in logs[1]


def test_serve_example_across_ranks(tmp_path, capsys):
  """The port's serve.py on two gloo ranks on the CPU: the leader's JSON
  block has the keys of the world-of-one run on the same checkpoint,
  every batched answer and every served overload answer is a gather of
  the bundle's rows, and the follower ran the leader's batches."""
  ckpt = str(tmp_path / 'ckpt.npz')
  dlrm_main.main(['--device', 'cpu', '--batch_size', '64', '--table_sizes',
                  '3000,2000,5000,1100', '--embedding_dim', '8',
                  '--bottom_mlp_dims', '16,8', '--top_mlp_dims', '16,1',
                  '--num_batches', '3', '--max_steps', '2',
                  '--save_state', ckpt])
  argv = ['--device', 'cpu', '--checkpoint', ckpt, '--batch', '32',
          '--requests', '48', '--hot_coverage', '0.9', '--overload_qps', '0',
          '--replicas', '2', '--deadline_ms', '5000']
  bundle = str(tmp_path / 'bundle.npz')
  trace = str(tmp_path / 'serve_trace.json')
  ranks = tmp_path / 'ranks'
  ranks.mkdir()
  torch_parity.spawn_ranks(torch_exchange_worker.serve_py,
                           {'argv': argv + ['--bundle', bundle, '--trace',
                                            trace],
                            'bundle': bundle}, ranks, world_size=2)
  # the leader's trace: the request path's spans, the broadcast and the
  # gather inside serve/lookup (no new span name)
  assert trace_report.main([trace, '--strict', '--require',
                            'serve/submit,serve/enqueue,serve/dispatch,'
                            'serve/lookup,serve/execute,serve/demux,'
                            'fwd/lookup_combine']) == 0
  lead, follower = [json.loads((ranks / f'serve_py{r}.json').read_text())
                    for r in range(2)]
  alone = dlrm_serve.main(argv)
  capsys.readouterr()
  stats = lead['returned']
  assert set(stats) == set(alone)
  assert stats['serve_requests'] == stats['serve_over_requests'] == 48
  assert stats['serve_over_served'] + stats['serve_over_shed'] == 48
  assert stats['serve_over_quarantined'] == 1
  assert lead['batched_equal'] == lead['batched_served'] >= 96
  assert lead['pool_resolved'] == lead['pool_requests'] == 48
  assert lead['pool_equal'] == lead['pool_served'] > 0
  counts = follower['returned']
  assert counts['rank'] == 1 and counts['batches'] > 0
  assert len(counts['by_replica']) == 2 and min(counts['by_replica']) > 0
