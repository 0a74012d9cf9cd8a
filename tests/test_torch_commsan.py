"""The port's rendezvous sanitizer (``distributed_embeddings_tpu_torch/
analysis/commsan.py``) against the JAX package's.

- the digest equals JAX's ``Capture`` bit for bit for the same records;
- a single-process barrier journals and passes; a disagreeing peer
  raises ``CommSequenceError`` with its witness (a shared
  ``torch.distributed.HashStore`` as the world's store); a peer that
  never publishes is reported, not waited on; a nested window restores
  the outer one; the events are registered;
- on two spawned gloo ranks ``fit`` with an auditor and a checkpoint
  callback passes every barrier with equal digests, and a rollback on
  one rank alone makes the next barrier raise ``CommSequenceError`` on
  both ranks instead of hanging.
"""

import json

import numpy as np
import pytest
import torch.distributed as torch_dist

from distributed_embeddings_tpu.analysis import commsan as jax_commsan
from distributed_embeddings_tpu_torch.analysis import commsan
from distributed_embeddings_tpu_torch.utils import resilience

import torch_exchange_worker
from torch_parity import spawn_ranks

RECORDS = [('fit/step', {'step': 1}),
           ('trace:fwd/ids', {'axis': 'data', 'legs': 1}),
           ('trace:fwd/rows', {'legs': 2, 'axis': 'data'}),
           ('audit/run', {'audit': 1}),
           ('fit/rollback', {'anomaly': 'audit_failure', 'to_step': 0,
                             'attempt': 1}),
           ('ckpt/restore', {'source': 'ckpt_2.npz'}),
           ('ckpt/save', {'step': None}),
           ('fit/skip_window', {})]


@pytest.fixture(autouse=True)
def _clear():
  resilience.clear_recent()


def test_digest_bit_equal_to_jax():
  with commsan.capture('t') as port, jax_commsan.capture('t') as jax:
    for site, info in RECORDS:
      port.record(site, **info)
      jax.record(site, **info)
      assert port.digest() == jax.digest()
      assert port.records == jax.records
      assert port.tail() == jax.tail()
  assert port.digest()[1] == len(RECORDS)


def test_record_hooks_outside_a_window_are_noops():
  assert commsan.active() is None
  commsan.record('fit/step', step=1)
  commsan.barrier_check('audit:1')
  assert commsan.report_active() is None
  assert not resilience.recent('commsan_digest')


def test_single_process_barrier_journals_and_passes():
  with commsan.capture('solo') as cap:
    commsan.record('fit/step', step=1)
    commsan.barrier_check('audit:1')
    assert cap.checks == 1 and not cap.mismatches
    rep = commsan.report_active()
  ev = resilience.recent('commsan_digest')
  assert len(ev) == 1
  assert (ev[0]['label'], ev[0]['tag'], ev[0]['records']) == \
      ('solo', 'audit:1', 1)
  assert "commsan capture 'solo'" in rep and '1 record(s)' in rep


def _shared_world(monkeypatch, rank=0, world=2):
  store = torch_dist.HashStore()
  monkeypatch.setattr(commsan, '_world', lambda: (world, rank, store))
  return store


def test_mismatch_raises_with_witness(monkeypatch):
  store = _shared_world(monkeypatch)
  store.set('commsan/drill/audit:1/1/1', '7:deadbeefdeadbeef')
  with commsan.capture('drill') as cap:
    commsan.record('fit/step', step=1)
    with pytest.raises(commsan.CommSequenceError) as ei:
      commsan.barrier_check('audit:1')
    wit = str(ei.value)
    assert "digest mismatch at barrier 'audit:1'" in wit
    assert 'rank 1 has 7:deadbeefdeadbeef' in wit
    assert 'fit/step[step=1]' in wit
    assert cap.mismatches == [wit]
    # this rank published before comparing: the peer can name it too
    mine = f'{cap.digest()[1]}:{cap.digest()[0]}'
    assert store.get('commsan/drill/audit:1/1/0').decode() == mine
  ev = resilience.recent('commsan_mismatch')
  assert len(ev) == 1 and ev[0]['peers'] == {'1': '7:deadbeefdeadbeef'}


def test_matching_peer_passes(monkeypatch):
  store = _shared_world(monkeypatch, rank=1)
  with commsan.capture('drill') as cap:
    commsan.record('fit/step', step=1)
    store.set('commsan/drill/ckpt:2/1/0',
              f'{cap.digest()[1]}:{cap.digest()[0]}')
    commsan.barrier_check('ckpt:2')
    assert cap.checks == 1 and not cap.mismatches


def test_peer_timeout_is_reported_not_wedged(monkeypatch):
  _shared_world(monkeypatch)
  with commsan.capture('drill', timeout_s=0.05):
    commsan.record('fit/step', step=1)
    with pytest.raises(commsan.CommSequenceError) as ei:
      commsan.barrier_check('ckpt:5')
  assert 'no digest within 0.05s' in str(ei.value)


def test_nested_capture_restores_outer():
  with commsan.capture('outer') as outer:
    with commsan.capture('inner') as inner:
      commsan.record('fit/step', step=1)
      assert commsan.active() is inner
    assert commsan.active() is outer
    assert outer.digest()[1] == 0 and inner.digest()[1] == 1
  assert commsan.active() is None


def test_events_registered():
  assert {'commsan_digest', 'commsan_mismatch'} <= \
      resilience.REGISTERED_EVENTS


def test_fit_barriers_on_two_ranks(tmp_path):
  """Two gloo ranks: ``fit`` with an auditor and a checkpoint callback
  passes its four barriers (two audits, two saves) with equal digests;
  then rank 1 alone rolls back at step 3, and the next barrier (the
  audit at step 4) raises ``CommSequenceError`` on both ranks."""
  rng = np.random.default_rng(3)
  specs = [(30, 4, 'sum'), (40, 8, 'sum')]
  batch = 8
  batches = [([rng.integers(0, r, size=(batch, 2)).astype(np.int32)
               for r, _, _ in specs],
              rng.normal(size=(batch, 1)).astype(np.float32))
             for _ in range(6)]
  case = {'tables': specs, 'batch': batch, 'batches': batches,
          'weights': [rng.normal(size=(r, w)).astype(np.float32)
                      for r, w, _ in specs],
          'kernel': rng.normal(size=(12, 1)).astype(np.float32),
          'steps': 6, 'every': 2, 'faulty_rank': 1, 'fault_step': 3,
          'timeout_s': 60.0}
  spawn_ranks(torch_exchange_worker.commsan_fit, case, tmp_path)
  ranks = [json.load(open(tmp_path / f'commsan{r}.json')) for r in range(2)]
  clean = [r['clean'] for r in ranks]
  assert all(c['error'] is None for c in clean), clean
  assert clean[0]['digest'] == clean[1]['digest']
  assert clean[0]['records'] == clean[1]['records']
  assert [c['checks'] for c in clean] == [6, 6]  # 3 audits, 3 saves
  sites = [s for s, _ in clean[0]['records_list']]
  assert sites.count('fit/step') == 6
  assert sites.count('audit/run') == 3 and sites.count('ckpt/save') == 3
  assert any(s.startswith('trace:') for s in sites)
  drill = [r['rollback'] for r in ranks]
  assert drill[1]['fired'] == [2] and drill[0]['fired'] == []
  for r, d in enumerate(drill):
    assert d['error'] is not None, (r, d)
    assert "digest mismatch at barrier 'audit:2'" in d['error']
  sites = [[s for s, _ in d['records_list']] for d in drill]
  assert 'fit/rollback' in sites[1] and 'ckpt/restore' in sites[1]
  assert 'fit/rollback' not in sites[0] and 'ckpt/restore' not in sites[0]
  assert drill[0]['digest'] != drill[1]['digest']
