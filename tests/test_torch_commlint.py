"""The port's commlint (``analysis/commlint.py``) and its CLIs
(``tools/commlint.py``, ``tools/lintall.py``) against the JAX package's
``tests/test_commlint.py``, case by case.

- ``divergence_witness`` and ``policy_sequences``: the same inputs give
  equal outputs in both packages.
- JAX's fixture trees in torch spellings give JAX's rule ids and
  symbols: a branch on ``torch.distributed.get_rank()`` reaching a
  collective; a handler of an exception one rank raises alone (the
  port's ``StepHangError``; ``TierIntegrityError``, which the port
  raises on every rank, is no finding here); the recovery pass under a
  rank-variant detection scope (and, under the port's own, only the
  registry drift); the emission failure shapes and the sync allowance;
  emission without a catalog is unverifiable.
- The live tree: strict-clean under the port's baseline, the waivers
  exactly the findings the passes re-derive without it; the emission
  pass matches every flagship program of the catalog on two spawned gloo
  ranks against the port's ledger; the rendezvous verdicts.
- The port's ``DETECTION_SCOPE`` held on two gloo ranks (the
  ``commlint_scope`` worker of tests/torch_exchange_worker.py): both
  ranks read the same losses, the same audit findings when one rank's
  host-tier row is corrupted, and raise ``TierIntegrityError`` at the
  same step when one rank's fetched row is.
- The CLI exit codes (0 / 1 / 2 / 3, as JAX's); ``lintall --only`` and
  ``run_all``'s one shared catalog build.
"""

import json
import pathlib
import textwrap

import numpy as np
import pytest

from distributed_embeddings_tpu.analysis import commlint as jax_commlint
from distributed_embeddings_tpu_torch.analysis import commlint
from distributed_embeddings_tpu_torch.analysis import core as lint_core
from distributed_embeddings_tpu_torch.analysis import graphlint
from distributed_embeddings_tpu_torch.tools import commlint as commlint_cli
from distributed_embeddings_tpu_torch.tools import lintall

import torch_exchange_worker
import torch_parity

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE = ROOT / 'distributed_embeddings_tpu_torch' / 'tools' / \
    'detlint_baseline.toml'
PKG = 'distributed_embeddings_tpu_torch'

# what the four passes find on the port's tree, each waived with a
# rationale in the port's baseline
WAIVED_TRUE_POSITIVES = {
    'rankvar/host-local-except-in-collective-path'
    f'@{PKG}/serving/bench.py::measure_overload:ReplicaLostError',
    f'rankvar/rank-variant-branch@{PKG}/parallel/dist_embedding.py::'
    'DistributedEmbedding._emit_outputs:D#1',
}


def _fixture_tree(tmp_path, files):
  """A mini tree commlint can walk: ``{relpath: source}``."""
  for rel, src in files.items():
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
  return str(tmp_path)


def _rules(res):
  return {f.rule for f in res.findings} | {f.rule for f in res.unverifiable}


@pytest.fixture(scope='module')
def catalog():
  """ONE flagship catalog for the module, on two spawned gloo ranks (at a
  world of one the port issues no collective to predict)."""
  return commlint.build_catalog('flagship', device='cpu')


@pytest.fixture(scope='module')
def live(catalog):
  return commlint.run_passes(str(ROOT),
                             baseline=lint_core.Baseline.load(str(BASELINE)),
                             programs=catalog)


# --------------------------------------------------------------------------
# the rendezvous model against JAX's
# --------------------------------------------------------------------------

STEPS = [
    [('all_to_all', 'data'), ('all_to_all', 'data')],
    [('all_to_all_single', 'data'), ('all_reduce', 'data'),
     ('all_to_all_single', 'data')],
    [],
]


@pytest.mark.parametrize('step', STEPS, ids=['jax', 'port', 'empty'])
@pytest.mark.parametrize('detect,window', [(2, 3), (1, 1), (3, 3)])
def test_policy_sequences_and_witnesses_equal_jax(step, detect, window):
  got = commlint.policy_sequences(step, detect_step=detect, window=window)
  want = jax_commlint.policy_sequences(step, detect_step=detect,
                                       window=window)
  assert got == want
  assert commlint.AUDIT_BARRIER_OP == jax_commlint.AUDIT_BARRIER_OP
  for a in got:
    for b in got:
      assert commlint.divergence_witness(
          got[a], got[b], pair=f'{a} x {b}', branch='seeded') == \
          jax_commlint.divergence_witness(
              want[a], want[b], pair=f'{a} x {b}', branch='seeded')


def test_seeded_rollback_skip_divergence_witness():
  """JAX's seeded drill: one rank down rollback_skip, its peer normal;
  the witness is the whole common window and the exact op pair."""
  step = [('all_to_all_single', 'data'), ('all_to_all_single', 'data')]
  seqs = commlint.policy_sequences(step, detect_step=2, window=3)
  wit = commlint.divergence_witness(seqs['normal'], seqs['rollback_skip'],
                                    pair='normal x rollback_skip',
                                    branch='seeded drill')
  assert wit['index'] == 3 * len(step)
  assert wit['lhs'] == 'all_gather@audit-barrier'
  assert wit['rhs'] == 'all_to_all_single@data'
  assert len(wit['prefix']) == wit['index']
  wit = commlint.divergence_witness(seqs['normal'], seqs['terminate'],
                                    pair='normal x terminate',
                                    branch='seeded drill')
  assert wit['index'] == 2 * len(step) and wit['rhs'] == '<exit>'
  assert commlint.divergence_witness(seqs['rollback'],
                                     seqs['rollback_skip'], pair='p',
                                     branch='b') is None


# --------------------------------------------------------------------------
# JAX's fixtures in torch spellings
# --------------------------------------------------------------------------


def test_fixture_rank_variant_branch(tmp_path):
  root = _fixture_tree(tmp_path, {
      f'{PKG}/x.py': """
          import torch.distributed as torch_dist

          def talk(x):
            out = x.clone()
            torch_dist.all_to_all_single(out, x)
            return out

          def bad(x):
            rank = torch_dist.get_rank()
            if rank == 0:
              return talk(x)          # only rank 0 dispatches
            return x

          def clean_no_collective(x):
            rank = torch_dist.get_rank()
            if rank == 0:
              return x + 1            # host-local work is fine
            return x

          def clean_uniform_branch(x, flag):
            if flag:                  # uniform predicate
              return talk(x)
            return x
          """})
  res = commlint.run_passes(root, passes=['rankvar'])
  hits = [f for f in res.findings if f.rule == 'rankvar/rank-variant-branch']
  assert len(hits) == 1, [f.brief() for f in res.findings]
  assert hits[0].symbol == 'bad:rank#1'
  assert 'talk' in hits[0].message
  assert not any('clean' in f.symbol for f in res.findings)


def test_fixture_layer_rank_is_a_source(tmp_path):
  """A layer's ``rank`` read into a local, and an autograd Function's
  ``apply`` of the port's own exchange, are a source and a seed."""
  root = _fixture_tree(tmp_path, {
      f'{PKG}/x.py': """
          def send(x, group):
            return _AllToAll.apply(x, group)

          def bad(self, x):
            me = self.rank
            if me == 1:
              return send(x, None)
            return x
          """})
  res = commlint.run_passes(root, passes=['rankvar'])
  assert {f.id for f in res.findings} == {
      f'rankvar/rank-variant-branch@{PKG}/x.py::bad:me#1'}


@pytest.mark.parametrize('exc,flagged', [('StepHangError', True),
                                         ('TierIntegrityError', False)])
def test_fixture_host_local_handler(tmp_path, exc, flagged):
  """JAX's fixture with an exception the port raises on one rank gives
  JAX's two rule ids; with ``TierIntegrityError`` (JAX's spelling of the
  fixture) it gives none: the port raises it on every rank."""
  root = _fixture_tree(tmp_path, {
      f'{PKG}/x.py': f"""
          import torch.distributed as torch_dist

          def talk(x):
            torch_dist.all_gather([x, x], x)
            return x

          def bad(x):
            try:
              return talk(x)
            except {exc}:
              return talk(x)          # dispatch only the failer runs

          def clean(x):
            try:
              return talk(x)
            except OSError:           # best-effort host leg: excluded
              return x
          """})
  res = commlint.run_passes(root, passes=['rankvar'])
  ids = {f.id for f in res.findings}
  want = {f'rankvar/host-local-except-in-collective-path@{PKG}/x.py::'
          f'bad:{exc}',
          f'rankvar/rank-variant-dispatch@{PKG}/x.py::bad:{exc}:talk'}
  assert ids == (want if flagged else set()), ids
  assert ('TierIntegrityError' in jax_commlint.HOST_LOCAL_EXCEPTIONS
          and 'TierIntegrityError' not in commlint.HOST_LOCAL_EXCEPTIONS)


def test_fixture_recovery_pass(tmp_path, monkeypatch):
  """Under a rank-variant detection (JAX's scope) a collective-bearing
  handler branch AND a registered-but-never-compared policy both fire;
  under the port's scope (every detection uniform) only the drift does;
  the clean twin fires nothing."""
  root = _fixture_tree(tmp_path, {
      f'{PKG}/parallel/grad.py': """
          import torch.distributed as torch_dist

          ANOMALY_POLICIES = ('terminate', 'rollback', 'spin')

          def sync(x):
            torch_dist.all_reduce(x)
            return x

          def handle_anomaly(policy, x):
            if policy == 'terminate':
              return None
            if policy == 'rollback':
              return sync(x)          # only the detecting rank runs this
            return x
          """})
  res = commlint.run_passes(root, passes=['recovery'])
  assert _rules(res) == {'recovery/unhandled-policy'}
  assert res.meta['commlint_recovery']['rollback'] == \
      'collective-bearing, on every rank'

  monkeypatch.setattr(commlint, 'DETECTION_SCOPE',
                      jax_commlint.DETECTION_SCOPE)
  res = commlint.run_passes(root, passes=['recovery'])
  assert _rules(res) == {'recovery/collective-in-recovery-path',
                         'recovery/unhandled-policy'}
  ids = {f.id for f in res.findings}
  assert any(i.endswith('::handle_anomaly:sync') for i in ids), ids
  assert any(i.endswith('::handle_anomaly:spin') for i in ids), ids
  assert res.meta['commlint_recovery']['spin'] == 'unhandled'

  clean = _fixture_tree(tmp_path / 'clean', {
      f'{PKG}/parallel/grad.py': """
          ANOMALY_POLICIES = ('terminate', 'rollback')

          def handle_anomaly(policy, x):
            if policy == 'terminate':
              return None
            if policy == 'rollback':
              return x - 1            # host-local restore
            return x
          """})
  res = commlint.run_passes(clean, passes=['recovery'])
  assert not res.findings, [f.brief() for f in res.findings]
  assert res.meta['commlint_recovery'] == {
      'terminate': 'zero-collectives', 'rollback': 'zero-collectives'}


def _emit_prog(name, plan_expect, sync_allowance=()):
  return graphlint.Program(name, plan_expect=plan_expect,
                           sync_allowance=sync_allowance)


def _a2a(shape, dtype='int32', axis='data'):
  return {'primitive': 'all_to_all_single', 'axis': axis, 'dtype': dtype,
          'shape': list(shape), 'leg': 'ids'}


def _row(shape, dtype='int32', axis='data', prim='all_to_all_single'):
  return {'primitive': prim, 'axis': axis, 'dtype': dtype,
          'shape': list(shape)}


def test_fixture_emission_mismatch_and_leftovers():
  ledger = {
      'fixture/mismatch': {'collectives': [_row([4, 2])]},
      'fixture/extra': {'collectives': [_row([4, 1]),
                                        _row([4, 8], 'float32')]},
      'fixture/missing': {'collectives': []},
  }
  programs = [_emit_prog(name, [_a2a([4, 1])]) for name in
              ('fixture/mismatch', 'fixture/extra', 'fixture/missing')]
  res = commlint.run_passes(str(ROOT), passes=['emission'],
                            programs=programs, ledger=ledger)
  by_rule = {}
  for f in res.findings:
    by_rule.setdefault(f.rule, []).append(f)
  assert [(f.path, f.symbol) for f in
          by_rule['emission/schedule-mismatch']] == [('fixture/mismatch',
                                                      'a2a#0')]
  assert [(f.path, f.symbol) for f in
          by_rule['emission/unpredicted-exchange']] == [('fixture/extra',
                                                         'a2a#1')]
  assert [(f.path, f.symbol) for f in
          by_rule['emission/missing-exchange']] == [('fixture/missing',
                                                     'leg:ids')]
  em = res.meta['commlint_emission']
  assert not any(v['matched'] for v in em.values()), em


def test_fixture_emission_sync_allowance():
  ledger = {'fixture/sync': {'collectives': [
      _row([4, 1]), _row([8, 5], 'float32', 'dcn', 'all_gather')]}}
  res = commlint.run_passes(str(ROOT), passes=['emission'],
                            programs=[_emit_prog('fixture/sync',
                                                 [_a2a([4, 1])])],
                            ledger=ledger)
  assert _rules(res) == {'emission/unpredicted-collective'}
  assert [f.symbol for f in res.findings] == ['all_gather@dcn#1']
  allowed = [_emit_prog('fixture/sync', [_a2a([4, 1])],
                        sync_allowance=(('all_gather', 'dcn'),))]
  res = commlint.run_passes(str(ROOT), passes=['emission'],
                            programs=allowed, ledger=ledger)
  assert not res.findings, [f.brief() for f in res.findings]
  assert res.meta['commlint_emission']['fixture/sync'] == {
      'predicted': 1, 'ledger': 2, 'allowed_sync': 1, 'matched': True}


def test_emission_without_catalog_is_unverifiable():
  ctx = lint_core.build_context(str(ROOT))
  cc = commlint.CommContext(ctx=ctx, ledger={}, programs=None)
  findings = commlint.PASSES['emission'](cc)
  assert [f.rule for f in findings] == ['emission/catalog-unavailable']
  assert not findings[0].verifiable
  res = commlint.run_passes(str(ROOT), passes=['emission'], programs=[],
                            ledger={})
  assert not res.findings
  assert res.meta['commlint_emission'] == {}
  assert res.meta['commlint_programs'] == []


# --------------------------------------------------------------------------
# the live tree
# --------------------------------------------------------------------------


def test_live_tree_commlint_strict_clean(live):
  assert not live.findings, [f.brief() for f in live.findings]
  assert not live.unverifiable, [f.brief() for f in live.unverifiable]
  assert not live.stale_waivers, live.stale_waivers
  assert not live.expired_waivers, live.expired_waivers
  assert {f.id for f in live.waived} == WAIVED_TRUE_POSITIVES


def test_lifting_the_baseline_rederives_the_waived_ids():
  res = commlint.run_passes(str(ROOT),
                            passes=['rankvar', 'rendezvous', 'recovery'])
  assert {f.id for f in res.findings} == WAIVED_TRUE_POSITIVES
  assert not res.unverifiable
  assert set(res.meta['commlint_recovery']) == {
      'terminate', 'rollback', 'rollback_skip'}
  # none of JAX's six recovery-path waivers is a finding here
  jax_six = lint_core.Baseline.load(
      str(ROOT / 'tools' / 'detlint_baseline.toml')).ids
  assert not {i.replace('distributed_embeddings_tpu/', f'{PKG}/')
              for i in jax_six if i.split('/')[0] in
              commlint.COMM_PASS_NAMES} & {f.id for f in res.findings}


def test_emission_predicts_the_ledger_for_every_flagship_program(live,
                                                                 catalog):
  em = live.meta['commlint_emission']
  names = {p.name for p in catalog}
  assert set(em) == names - {'serve/ladder-warm'}, sorted(em)
  assert all(v['matched'] and v['ledger'] is not None
             for v in em.values()), em
  assert sorted(em) == live.meta['commlint_programs']
  # the train steps' dense-gradient means are the only declared syncs
  assert em['train/monolithic']['allowed_sync'] == 7
  assert em['lookup/fused'] == {'predicted': 2, 'ledger': 2,
                                'allowed_sync': 0, 'matched': True}


def test_plan_rows_name_the_ledger_rows(catalog):
  """``graphlint.leg_row`` is the one mapping from a plan leg to the row
  the port records: the function renamed, axis, dtype and shape kept."""
  ledger = commlint.default_ledger(str(ROOT))
  prog = {p.name: p for p in catalog}['lookup/pergroup']
  assert [(r['primitive'], r['axis'], r['dtype'], r['shape'])
          for r in prog.plan_expect] == [
              (r['primitive'], r['axis'], r['dtype'], r['shape'])
              for r in ledger['lookup/pergroup']['collectives']]
  # the dense backward is the transpose of the forward's row legs
  bwd = {p.name: p for p in catalog}['bwd/pergroup']
  assert [r['shape'] for r in bwd.plan_expect] == [[2, 1, 8, 16],
                                                   [2, 1, 8, 8]]


def test_rendezvous_verdicts_on_the_live_ledger(live):
  rv = live.meta['commlint_rendezvous']
  wit = live.meta['commlint_witnesses']
  for policy in ('terminate', 'rollback', 'rollback_skip'):
    assert rv[f'normal x {policy}'] == 'uniform'
    w = wit[f'normal x {policy}']
    assert w['index'] >= 1 and w['lhs'] != w['rhs'], w
  assert rv['rollback x rollback_skip'] == 'identical'
  assert rv['restore(n) x restore(m)'] == 'identical'
  serve_pairs = [k for k in rv if k.startswith('serve/')]
  assert serve_pairs and all(rv[k] == 'identical' for k in serve_pairs)


def test_a_variant_scope_turns_the_pairs_into_findings(monkeypatch):
  """The same ledger under JAX's scope: the three policy pairs are the
  witnesses JAX waives."""
  monkeypatch.setattr(commlint, 'DETECTION_SCOPE',
                      jax_commlint.DETECTION_SCOPE)
  res = commlint.run_passes(str(ROOT), passes=['rendezvous'])
  assert {f.symbol for f in res.findings} == {
      'fit:normal x terminate', 'fit:normal x rollback',
      'fit:normal x rollback_skip'}


def test_detection_scope_on_two_ranks(tmp_path):
  """Each ``uniform`` entry of ``DETECTION_SCOPE`` on two gloo ranks."""
  rng = np.random.default_rng(5)
  tables = [(96, 8, 'sum'), (64, 8, 'sum'), (200, 16, 'mean'),
            (48, 4, None)]
  batch = 16

  def ids():
    return [rng.integers(0, r, size=(batch,) if c is None else (batch, 3)
                         ).astype(np.int32) for r, _, c in tables]

  case = {'tables': tables, 'hot': {0: [0, 1, 7], 2: list(range(10))},
          'weights': [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
                      for r, w, _ in tables],
          'kernel': (rng.standard_normal((36, 1)) * 0.1).astype(np.float32),
          'labels': rng.normal(size=(batch, 1)).astype(np.float32),
          'batches': [ids() for _ in range(4)], 'batch': batch,
          'budget_frac': 0.6, 'corrupt_at': 2}
  torch_parity.spawn_ranks(torch_exchange_worker.commlint_scope, case,
                           tmp_path)
  r0, r1 = [json.loads((tmp_path / f'scope{r}.json').read_text())
            for r in range(2)]
  # losses: averaged over the ranks before fit reads them
  assert r0['local_loss'] != r1['local_loss']
  assert r0['sparse_loss'] == r1['sparse_loss']
  assert r0['dense_loss'] == r1['dense_loss']
  # audit_failure: one rank's corrupted row, the same findings on both
  assert r0['audit_clean'] == r1['audit_clean'] == []
  assert r0['audit_one_rank'] == r1['audit_one_rank'] != []
  assert r0['audit_one_rank'][0][1] == [1]
  # tier_integrity: one rank's fetched row, both raise at that step
  assert r1['corrupted'] is not None and r0['corrupted'] is None
  assert r0['raised_at'] == r1['raised_at'] == 2
  assert 'checksum mismatch' in r0['error']


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------


def test_cli_refuses_a_rationale_less_baseline_fast(tmp_path):
  bad = tmp_path / 'bad.toml'
  bad.write_text('[[waiver]]\nid = "rankvar/x@y::z"\n')
  assert commlint_cli.main(['--baseline', str(bad),
                            '--passes', 'rankvar']) == 2


def test_cli_model_passes_exit_codes(tmp_path):
  """Without the emission pass no program runs: exit 0 under the live
  baseline, 1 with none, 3 under --strict with an expired waiver."""
  passes = ['--passes', 'rankvar,rendezvous,recovery']
  assert commlint_cli.main(passes) == 0
  empty = tmp_path / 'empty.toml'
  empty.write_text('')
  assert commlint_cli.main(['--baseline', str(empty)] + passes) == 1
  a, b = sorted(WAIVED_TRUE_POSITIVES)
  expired = tmp_path / 'expired.toml'
  expired.write_text(textwrap.dedent(f'''
      [[waiver]]
      id = "{a}"
      rationale = "fixture: expired waiver"
      expires = "2020-01-01"

      [[waiver]]
      id = "{b}"
      rationale = "fixture: still-valid waiver"
      expires = "2099-01-01"
  '''))
  assert commlint_cli.main(['--baseline', str(expired),
                            '--passes', 'rankvar']) == 0
  assert commlint_cli.main(['--baseline', str(expired), '--strict',
                            '--passes', 'rankvar']) == 3


def test_cli_emission_on_the_cpu(capsys):
  assert commlint_cli.main(['--device', 'cpu', '--strict',
                            '--passes', 'emission']) == 0
  assert 'program schedule(s) predicted from plans' in capsys.readouterr().out


def test_lintall_rejects_an_unknown_tool_and_runs_a_subset():
  assert lintall.main(['--only', 'nosuchtool']) == 2
  assert lintall.main(['--only', 'detlint']) == 0
  assert lintall.main(['--only', 'detlint,commlint', '--device', 'cpu',
                       '--strict']) == 0


def test_lintall_without_a_card_raises(monkeypatch):
  """Like graphlint's CLI, the catalog runs on the card by default and
  a run without one is malformed (exit 2), never a CPU fallback."""
  import torch
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  assert lintall.main(['--only', 'graphlint']) == 2
  assert commlint_cli.main(['--passes', 'emission']) == 2


def test_lintall_run_all_shares_the_program_catalog(catalog, monkeypatch):
  baseline = lint_core.Baseline.load(str(BASELINE))
  builds = []

  def fake_build(tier='flagship', device=None, world=None):
    builds.append((tier, device, world))
    return catalog

  monkeypatch.setattr(graphlint, 'build_programs', fake_build)
  out = lintall.run_all(str(ROOT), baseline,
                        only=['graphlint', 'commlint'], device='cpu')
  assert builds == [('flagship', 'cpu', commlint.CATALOG_WORLD)]
  for tool in ('graphlint', 'commlint'):
    res = out[tool]
    assert not isinstance(res, Exception), (tool, res)
    assert not res.findings, (tool, [f.brief() for f in res.findings])
  want = sorted(p.name for p in catalog if p.plan_expect is not None)
  assert sorted(out['commlint'].meta['commlint_emission']) == want
