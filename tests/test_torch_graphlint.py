"""graphlint over the port (``distributed_embeddings_tpu_torch/analysis/
graphlint.py``), the port's twin of tests/test_graphlint.py.

- the world-of-one catalog on the CPU is strict-clean under the port's
  baseline (and so is the CLI), with every train-state leaf updated in
  place, no kernel build after the warm-up and the cold tier's resident
  bytes under its budget;
- one seeded fixture per pass: an out-of-place state leaf, a divergent
  parity schedule and a rank that walked another schedule, signature
  drift and a build after warm-up, an injected ``.item()``, resident
  bytes over the budget;
- ids are stable across reruns; waivers, staleness and backend scope
  behave as specified; the CLI refuses a baseline without a rationale
  before any program runs, and the card when it has none;
- two spawned gloo ranks record the schedules the port's ledger holds;
- against the JAX package's checked-in ``tools/graphlint_ledger.json``,
  read as a file: each counterpart program's collapsed schedule, mapped
  to JAX's primitives, equals JAX's once the differences listed below
  (each with the line that causes it) are taken out, and the monolithic
  and fused programs ship the same number of exchanges.
"""

import json
import pathlib

import pytest
import torch

from distributed_embeddings_tpu_torch.analysis import core as lint_core
from distributed_embeddings_tpu_torch.analysis import graphlint
from distributed_embeddings_tpu_torch.tools import graphlint as graphlint_cli
from distributed_embeddings_tpu_torch.utils import nativebuild

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = 'distributed_embeddings_tpu_torch'
BASELINE = ROOT / PKG / 'tools' / 'detlint_baseline.toml'
PORT_LEDGER = ROOT / PKG / 'tools' / 'graphlint_ledger.json'
JAX_LEDGER = ROOT / 'tools' / 'graphlint_ledger.json'


@pytest.fixture(scope='module')
def catalog():
  return graphlint.build_programs(device='cpu')


@pytest.fixture(scope='module')
def live(catalog):
  return graphlint.run_programs(catalog,
                                baseline=lint_core.Baseline.load(str(BASELINE)))


# --------------------------------------------------------------- live tree


def test_live_catalog_strict_clean(live):
  assert not live.findings, '\n'.join(f.brief() for f in live.findings)
  assert not live.unverifiable
  assert not live.stale_waivers, live.stale_waivers
  assert not live.expired_waivers, live.expired_waivers
  assert live.meta['graphlint_backend'] == 'cpu'
  names = set(live.meta['graphlint_programs'])
  assert {'lookup/hot', 'lookup/fused', 'lookup/pergroup', 'lookup/wire-off',
          'lookup/wire-on', 'bwd/fused', 'bwd/pergroup', 'bwd/wire-off',
          'bwd/wire-on', 'train/monolithic', 'train/chunked', 'serve/rung8',
          'serve/rung16', 'serve/ladder-warm', 'serve/coldfetch'} <= names
  # a world of one issues no collective
  assert all(not s['collectives']
             for s in live.meta['graphlint_schedule'].values())


def test_cli_strict_exit_zero_on_the_cpu():
  assert graphlint_cli.main(['--device', 'cpu', '--strict']) == 0


def test_cli_refuses_without_a_card():
  if torch.cuda.is_available():
    pytest.skip('a card is present')
  assert graphlint_cli.main([]) == 2


def test_train_state_updated_in_place(live):
  don = live.meta['graphlint_donation']
  assert set(don) == {'train/monolithic', 'train/chunked'}
  for name, d in don.items():
    assert d['expected'] >= 10, (name, d)  # tables, accumulators, MLP
    assert d['inplace'] == d['expected'], (name, d)


def test_no_build_after_warmup(live):
  ret = live.meta['graphlint_retrace']
  assert ret['train/monolithic'] == {'calls': 3, 'builds': 0}
  assert ret['serve/ladder-warm']['builds'] == 0


def test_hbm_budget_crosscheck(live):
  hbm = live.meta['graphlint_hbm']
  cf = hbm['serve/coldfetch']
  assert cf['budget'] is not None
  assert 0 < cf['resident_state'] <= cf['budget'], cf
  assert all(v['peak'] is None for v in hbm.values())  # no card here
  assert hbm['train/monolithic']['resident_state'] > \
      hbm['serve/rung8']['resident_state']


# ------------------------------------------------------------- fixtures


def _donation_program(name):
  w, acc = torch.ones(4, 4), torch.ones(4, 4)
  state = {'w': w, 'acc': acc}
  before = graphlint.storage_ptrs(state)
  state = {'w': w.add_(1.0), 'acc': acc * 2}  # acc: a new buffer
  after = graphlint.storage_ptrs(state)
  return graphlint.Program(name, donation=[
      (leaf, after[leaf] == ptr) for leaf, ptr in sorted(before.items())])


def test_fixture_out_of_place_leaf():
  res = graphlint.run_programs([_donation_program('fixture/step')],
                               passes=['donation'])
  assert [f.id for f in res.findings] == \
      ["donation/undonated-leaf@fixture/step::['acc']"]
  assert res.meta['graphlint_donation'] == {
      'fixture/step': {'expected': 2, 'inplace': 1}}


def _ops(*keys):
  return [graphlint.CollectiveOp(p, a, (), i) for i, (p, a) in enumerate(keys)]


def test_fixture_divergent_parity_schedule():
  a2a, psum = ('all_to_all_single', 'data'), ('all_reduce', 'data')
  mono = graphlint.Program('fixture/mono', collectives=_ops(a2a, psum),
                           parity='pair')
  bad = graphlint.Program('fixture/chunked',
                          collectives=_ops(psum, a2a, psum), parity='pair')
  res = graphlint.run_programs([mono, bad], passes=['schedule'])
  assert [f.id for f in res.findings] == \
      ['schedule/parity-divergence@fixture/chunked::pair']
  # an order-preserving chunk split collapses onto the monolithic one
  ok = graphlint.Program('fixture/chunked-ok',
                         collectives=_ops(a2a, a2a, psum), parity='pair')
  assert not graphlint.run_programs([mono, ok],
                                    passes=['schedule']).findings
  # a rank that walked another schedule
  split = graphlint.Program('fixture/split', collectives=_ops(a2a),
                            rank_schedules={1: [a2a, psum]})
  res = graphlint.run_programs([split], passes=['schedule'])
  assert [f.id for f in res.findings] == \
      ['schedule/rank-divergence@fixture/split::rank1']


def test_schedule_recorder_sees_the_module_attributes(monkeypatch):
  """The recorder wraps ``torch.distributed``'s functions for its window
  and restores them; every call through the attribute is recorded with
  its operand and reduce op."""
  import torch.distributed as torch_dist
  calls = []
  monkeypatch.setattr(torch_dist, 'all_reduce',
                      lambda *a, **k: calls.append('all_reduce'))
  monkeypatch.setattr(torch_dist, 'all_to_all_single',
                      lambda *a, **k: calls.append('all_to_all_single'))
  fake = torch_dist.all_reduce
  rec = graphlint.ScheduleRecorder()
  with rec:
    torch_dist.all_to_all_single(torch.empty(2, 3), torch.ones(2, 3,
                                                                dtype=torch.int32))
    torch_dist.all_reduce(torch.ones(4), op=torch_dist.ReduceOp.MAX)
  assert torch_dist.all_reduce is fake
  assert calls == ['all_to_all_single', 'all_reduce']
  assert [op.as_dict() for op in rec.ops] == [
      {'primitive': 'all_to_all_single', 'axis': 'data', 'shape': [2, 3],
       'index': 0, 'loop': False, 'dtype': 'int32', 'op': ''},
      {'primitive': 'all_reduce', 'axis': 'data', 'shape': [4], 'index': 1,
       'loop': False, 'dtype': 'float32', 'op': 'max'}]


def test_fixture_signature_drift_and_build_after_warmup(monkeypatch):
  leaf = torch.ones(3, dtype=torch.bfloat16)
  sig1 = graphlint.signature({'acc': leaf}, [1, 2])
  # the leaf promoted to f32 by an f32 operand: the eager counterpart of
  # JAX's weak_type promotion
  sig2 = graphlint.signature({'acc': leaf + torch.ones(3)}, [1, 2])
  # builds and loads after the warm-up: nativebuild.load builds through
  # the module's own name, so the counter sees it
  monkeypatch.setattr(nativebuild, 'build', lambda name: nativebuild.Built(
      name, pathlib.Path('/nonexistent'), 0.0, ''))
  monkeypatch.setattr(nativebuild.ctypes, 'CDLL', lambda path: object())
  monkeypatch.setattr(nativebuild, '_loaded', {})
  with graphlint.BuildCounter() as counter:
    nativebuild.load('lookup_combine')
    nativebuild.load('lookup_combine')  # cached: no second build
  assert counter.builds == 1
  rec = graphlint.RetraceRecord(calls=2, sigs=[sig1, sig2],
                                builds=counter.builds)
  res = graphlint.run_programs([graphlint.Program('fixture/drift',
                                                  retrace=rec)],
                               passes=['retrace'])
  assert {f.rule for f in res.findings} == {'retrace/signature-drift',
                                            'retrace/recompile'}
  drift = next(f for f in res.findings
               if f.rule == 'retrace/signature-drift')
  assert drift.symbol == "[0]['acc']"
  assert 'dtype bfloat16 -> float32' in drift.message
  ok = graphlint.RetraceRecord(calls=3, sigs=[sig1, sig1, sig1])
  assert not graphlint.run_programs(
      [graphlint.Program('fixture/stable', retrace=ok)],
      passes=['retrace']).findings


def test_fixture_injected_host_sync():
  x = torch.arange(6.0)
  with graphlint.HostSyncMonitor('cpu') as mon:
    x.sum().item()
    x.tolist()
  with graphlint.HostSyncMonitor('cuda') as other:
    x.sum().item()  # a CPU tensor: no pull from the card
  site = 'test_torch_graphlint.py:test_fixture_injected_host_sync'
  assert mon.sites == [site, site]
  assert other.sites == []
  assert torch.Tensor.item.__qualname__ == 'TensorBase.item'  # restored
  res = graphlint.run_programs(
      [graphlint.Program('fixture/sync',
                         hostsync=graphlint.HostSyncRecord(mon.sites,
                                                           calls=2))],
      passes=['hostsync'])
  assert [f.id for f in res.findings] == [
      'hostsync/host-sync-in-hot-loop@test_torch_graphlint.py'
      '::test_fixture_injected_host_sync']
  assert res.meta['graphlint_hostsync']['fixture/sync'] == {
      'calls': 2, 'per_call': 1.0, 'sites': {site: 1.0}}


def test_fixture_hbm_over_budget():
  res = graphlint.run_programs(
      [graphlint.Program('fixture/oom', hbm_budget=1,
                         resident_state_bytes=4096)], passes=['hbm'])
  assert [f.id for f in res.findings] == \
      ['hbm/over-budget@fixture/oom::resident_bytes']
  assert not graphlint.run_programs(
      [graphlint.Program('fixture/fits', hbm_budget=8192,
                         resident_state_bytes=4096)],
      passes=['hbm']).findings


def test_resident_bytes_count_each_storage_once():
  t = torch.zeros(8, 4)
  assert graphlint.measure_resident_bytes({'a': t, 'b': t[2:4],
                                           'c': [t]}) == 8 * 4 * 4
  assert graphlint.measure_resident_bytes(
      {'a': t, 'b': torch.zeros(3, dtype=torch.int64)}) == 128 + 24


# ------------------------------------------- ids, waivers and the CLI


def test_finding_ids_stable_across_reruns():
  ids = [sorted(f.id for f in graphlint.run_programs(
      [_donation_program('fixture/step')], passes=['donation']).findings)
         for _ in range(2)]
  assert ids[0] == ids[1] and ids[0]


def test_waivers_staleness_and_backend_scope(tmp_path):
  fid = graphlint.run_programs([_donation_program('fixture/step')],
                               passes=['donation']).findings[0].id
  base = tmp_path / 'base.toml'
  base.write_text(
      f'[[waiver]]\nid = "{fid}"\nrationale = "fixture: seeded"\n'
      '[[waiver]]\nid = "donation/undonated-leaf@gone::x"\n'
      'rationale = "stale on purpose"\n'
      '[[waiver]]\nid = "donation/undonated-leaf@card::y"\n'
      'rationale = "seen on the card only"\nbackends = "cuda"\n'
      '[[waiver]]\nid = "purity/host-effect-in-traced@other::y"\n'
      'rationale = "owned by detlint: never stale here"\n')
  b = lint_core.Baseline.load(str(base))
  res = graphlint.run_programs([_donation_program('fixture/step')],
                               passes=['donation'], baseline=b,
                               backend='cpu')
  assert [f.id for f in res.waived] == [fid] and not res.findings
  assert res.stale_waivers == ['donation/undonated-leaf@gone::x']
  on_card = graphlint.run_programs([_donation_program('fixture/step')],
                                   passes=['donation'], baseline=b,
                                   backend='cuda')
  assert on_card.stale_waivers == ['donation/undonated-leaf@card::y',
                                   'donation/undonated-leaf@gone::x']


def test_cli_refuses_rationale_less_baseline_fast(tmp_path, monkeypatch):
  bad = tmp_path / 'base.toml'
  bad.write_text('[[waiver]]\nid = "donation/x@y::z"\n')

  def no_programs(**kw):
    raise AssertionError('a program ran before the baseline was checked')

  monkeypatch.setattr(graphlint, 'build_programs', no_programs)
  assert graphlint_cli.main(['--device', 'cpu', '--baseline',
                             str(bad)]) == 2
  assert graphlint_cli.main(['--device', 'cpu', '--write-ledger']) == 2


# ---------------------------------------------------------- the ledgers


def test_two_ranks_schedules_equal_the_ledger():
  """Two spawned gloo ranks: every program's recorded schedule equals the
  port's checked-in ledger (refresh it with ``python -m
  distributed_embeddings_tpu_torch.tools.graphlint --device cpu --tier
  full --write-ledger``), the ranks agree, and every pass is clean."""
  programs = graphlint.build_programs(device='cpu', world=2)
  with open(PORT_LEDGER, encoding='utf-8') as f:
    ledger = json.load(f)
  live = graphlint.schedule_ledger(programs)
  assert set(live) <= set(ledger)
  for name, entry in live.items():
    assert entry['collectives'], name  # two ranks exchange
    assert ledger[name] == json.loads(json.dumps(entry)), name
  assert all(p.rank_schedules is None for p in programs)
  res = graphlint.run_programs(
      programs, baseline=lint_core.Baseline.load(str(BASELINE)))
  assert not res.findings, [f.brief() for f in res.findings]
  # the hierarchical pair (four ranks, --tier full) is in the ledger too
  assert {'train/hierarchical', 'train/hier-flat-twin'} <= set(ledger)


@pytest.mark.slow
def test_four_ranks_hierarchical_schedules_equal_the_ledger():
  programs = graphlint.run_ranks(4, 'hier')
  with open(PORT_LEDGER, encoding='utf-8') as f:
    ledger = json.load(f)
  live = graphlint.schedule_ledger(programs)
  assert set(live) == {'train/hierarchical', 'train/hier-flat-twin'}
  for name, entry in live.items():
    assert ledger[name] == json.loads(json.dumps(entry)), name


# JAX's primitives for the port's functions
_JAX_PRIMITIVE = {('all_to_all_single', ''): 'all_to_all',
                  ('all_reduce', 'sum'): 'psum',
                  ('all_reduce', 'max'): 'pmax',
                  ('all_gather', ''): 'all_gather'}

# What the port issues that JAX's ledger has no row for, by program, with
# the line that issues it:
# - the train steps average the dense gradients and the loss over the
#   ranks themselves (grad.py:92, one all_reduce a dense leaf and one for
#   the loss); JAX's jitted step leaves the data-parallel mean to XLA,
#   outside the shard_map its ledger reads;
# - the hierarchical steps' cross-slice streams all-gather each slice's
#   stream length first (sparse.py:527 in the flat twin, :560 in the
#   sharded arm): torch's all_gather needs equal sizes, where JAX ships a
#   static-capacity buffer.
_PORT_ONLY = {
    'train/monolithic': {('psum', 'data')},
    'train/chunked': {('psum', 'data')},
    'train/hier-flat-twin': {('psum', 'product'),
                             ('all_gather', 'dcn', 'int64')},
    'train/hierarchical': {('psum', 'product'),
                           ('all_gather', 'dcn', 'int64')},
}
# JAX rows with no port program (graphlint.NO_COUNTERPART says why) and
# port rows with no JAX program: the port's ladder at a world of two has
# rungs below JAX's eight-device minimum
_JAX_ONLY = {'lookup/xla', 'lookup/pallas', 'lookup/sparsecore'}
_PORT_ONLY_PROGRAMS = {'serve/rung2', 'serve/rung4'}


def _mapped(entry, drop=()):
  keys = []
  for op in entry['collectives']:
    prim = _JAX_PRIMITIVE.get((op['primitive'], op.get('op', '')),
                              op['primitive'])
    if (prim, op['axis']) in drop or \
        (prim, op['axis'], op.get('dtype')) in drop:
      continue
    keys.append((prim, op['axis']))
  return keys


def _collapse(keys):
  out = []
  for k in keys:
    if not out or out[-1] != k:
      out.append(k)
  return out


def test_ledger_parity_with_jax():
  with open(JAX_LEDGER, encoding='utf-8') as f:
    jax_ledger = json.load(f)
  with open(PORT_LEDGER, encoding='utf-8') as f:
    port_ledger = json.load(f)
  assert set(jax_ledger) - set(port_ledger) == _JAX_ONLY
  assert _JAX_ONLY <= set(graphlint.NO_COUNTERPART)
  assert set(port_ledger) - set(jax_ledger) == _PORT_ONLY_PROGRAMS
  for name in sorted(set(jax_ledger) & set(port_ledger)):
    drop = _PORT_ONLY.get(name, ())
    want = _collapse([(c['primitive'], c['axis'])
                      for c in jax_ledger[name]['collectives']])
    got = _collapse(_mapped(port_ledger[name], drop))
    assert got == want, name
    assert port_ledger[name]['parity'] == jax_ledger[name]['parity'] or \
        name.startswith('train/hier'), name
    # every listed difference is really there
    if drop:
      assert len(_mapped(port_ledger[name])) > len(
          _mapped(port_ledger[name], drop)), name
  # the monolithic and fused programs ship as many exchanges as JAX's;
  # the chunked step ships one a chunk (two chunks), JAX's one
  def exchanges(ledger, name):
    return sum(c['primitive'] in ('all_to_all', 'all_to_all_single')
               for c in ledger[name]['collectives'])

  for name in ('train/monolithic', 'lookup/fused', 'bwd/fused'):
    assert exchanges(port_ledger, name) == exchanges(jax_ledger, name), name
  assert exchanges(port_ledger, 'train/chunked') > \
      exchanges(jax_ledger, 'train/chunked')
