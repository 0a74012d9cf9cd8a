"""detlint over the port (``distributed_embeddings_tpu_torch/analysis``),
the port's twin of tests/test_lint.py.

- the live tree is strict-clean and the CLI exits 0, every pass having
  run over real sites;
- every fixture case of tests/test_lint.py, rewritten against the port's
  module names (the purity pass's roots are the port's own: the
  ``forward`` / ``backward`` of a ``torch.autograd.Function`` and the
  step a ``make_*`` factory returns);
- the waiver policy (rationale, staleness, expiry, backend scope) and
  line-stable ids;
- parity with the JAX package: the concurrency fixtures give identical
  finding ids through both packages' ``run_passes``, the same baseline
  text gives the same waivers, staleness, expiry and ``BaselineError``s,
  and one acquisition script under both ``locksan``s gives the same
  cycle;
- the port's ``locksan``, as tests/test_lint.py holds JAX's.
"""

import pathlib
import queue as queue_mod
import textwrap
import threading

import pytest

from distributed_embeddings_tpu.analysis import core as jax_core
from distributed_embeddings_tpu.analysis import locksan as jax_locksan
from distributed_embeddings_tpu_torch.analysis import (Baseline,
                                                       BaselineError,
                                                       locksan, run_passes,
                                                       run_repo)
from distributed_embeddings_tpu_torch.analysis import core as lint_core
from distributed_embeddings_tpu_torch.tools import detlint

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = 'distributed_embeddings_tpu_torch'
BASELINE = ROOT / PKG / 'tools' / 'detlint_baseline.toml'


def _tree(tmp_path, files):
  """A mini tree detlint can walk: {relpath: source}."""
  for rel, src in files.items():
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
  return str(tmp_path)


def _cli(root, tmp_path, *args):
  return detlint.main(['--root', root, '--baseline',
                       str(tmp_path / 'none.toml'), *args])


def _rules(res):
  return {f.rule for f in res.findings} | {f.rule for f in res.unverifiable}


# --------------------------------------------------------------- live tree


def test_live_tree_detlint_strict_clean():
  res = run_repo(str(ROOT))
  assert not res.findings, '\n'.join(f.brief() for f in res.findings)
  assert not res.unverifiable, \
      '\n'.join(f.brief() for f in res.unverifiable)
  assert not res.stale_waivers, res.stale_waivers
  assert not res.expired_waivers, res.expired_waivers
  base = Baseline.load(str(BASELINE))
  owned = [w for w in base.waivers
           if w['id'].split('/', 1)[0] in lint_core.list_passes()]
  assert len(owned) == len(res.waived)
  # every pass ran over real sites of the port
  assert res.meta['registry_sites']['journal'] > 10
  assert res.meta['registry_sites']['span'] > 10
  assert res.meta['registry_sites']['metric'] > 10
  assert res.meta['lock_graph']['locks'] >= 10
  assert res.meta['lock_graph']['threads'] >= 5
  assert res.meta['purity']['roots'] > 10
  assert res.meta['docdrift_api_symbols'] > 30
  assert res.meta['docdrift_cli_flags'] > 50
  assert res.meta['docdrift_section_refs'] > 50


def test_live_tree_cli_strict_exit_zero():
  assert detlint.main(['--strict']) == 0


def test_pass_subset_does_not_stale_other_passes_waivers():
  assert detlint.main(['--passes', 'registry', '--strict']) == 0


def test_scans_the_port_not_the_jax_package():
  ctx = lint_core.build_context(str(ROOT))
  assert ctx.modules
  assert all(rel.startswith(PKG + '/') for rel in ctx.modules)
  assert f'{PKG}/analysis/graphlint.py' in ctx.modules
  assert lint_core.default_baseline_path(str(ROOT)) == str(BASELINE)


# ------------------------------------------------------------ registry


def test_fixture_unregistered_journal_name(tmp_path):
  root = _tree(tmp_path, {f'{PKG}/bad.py': f"""
      from {PKG}.utils.resilience import journal

      def oops():
        journal('definitely_not_a_registered_event', x=1)
      """})
  res = run_passes(root, passes=['registry'])
  hits = [f for f in res.findings
          if f.rule == 'registry/journal-unregistered']
  assert [f.symbol for f in hits] == ['definitely_not_a_registered_event']
  assert _cli(root, tmp_path, '--passes', 'registry') == 1


def test_fixture_aliased_import_still_resolves(tmp_path):
  root = _tree(tmp_path, {f'{PKG}/bad.py': f"""
      from {PKG}.utils.resilience import (journal as log_event)

      def oops():
        log_event('sneaky_unregistered_event')
      """})
  res = run_passes(root, passes=['registry'])
  assert any(f.rule == 'registry/journal-unregistered'
             and f.symbol == 'sneaky_unregistered_event'
             for f in res.findings)


def test_fixture_derived_name_is_unverifiable_not_silent(tmp_path):
  root = _tree(tmp_path, {f'{PKG}/bad.py': f"""
      from {PKG}.utils import resilience

      def oops(which):
        resilience.journal(f'event_{{which}}')
      """})
  res = run_passes(root, passes=['registry'])
  assert not res.findings
  assert [f.rule for f in res.unverifiable] == ['registry/unverifiable-name']
  assert _cli(root, tmp_path, '--passes', 'registry') == 0
  assert _cli(root, tmp_path, '--passes', 'registry', '--strict') == 3


def test_fixture_unregistered_span_and_metric(tmp_path):
  root = _tree(tmp_path, {f'{PKG}/bad.py': f"""
      from {PKG}.obs import trace as obs_trace
      from {PKG}.obs import metrics as obs_metrics

      def oops():
        with obs_trace.span('no/such_phase'):
          obs_metrics.inc('no.such_metric')
      """})
  res = run_passes(root, passes=['registry'])
  rules = {(f.rule, f.symbol) for f in res.findings}
  assert ('registry/span-unregistered', 'no/such_phase') in rules
  assert ('registry/metric-unregistered', 'no.such_metric') in rules


def test_fixture_stats_key_discipline(tmp_path):
  root = _tree(tmp_path, {f'{PKG}/bad.py': """
      class Component:
        def stats(self):
          return {'batches': 1, 'gather_ms': 2.0,
                  'not_a_registered_stats_key': 3}
      """})
  res = run_passes(root, passes=['registry'])
  hits = [f for f in res.findings
          if f.rule == 'registry/stats-key-unregistered']
  # 'gather_ms' is one of the port's own keys (PORT_STATS_KEYS)
  assert [f.symbol for f in hits] == \
      ['Component.stats:not_a_registered_stats_key']
  root2 = _tree(tmp_path / 'derived', {f'{PKG}/bad2.py': """
      class Component:
        def stats(self):
          out = {}
          out[f'{self.prefix}_ms'] = 1.0
          return out
      """})
  res2 = run_passes(root2, passes=['registry'])
  assert any(f.rule == 'registry/unverifiable-name'
             and f.symbol.startswith('stats-key:Component.stats')
             for f in res2.unverifiable)


def test_fixture_artifact_key_unproduced(tmp_path):
  """The rule arms only on a tree with the port's own benchmark
  (``distributed_embeddings_tpu_torch/bench.py``); docstrings and the
  registry module are never producers."""
  root = _tree(tmp_path, {f'{PKG}/bench.py': """
      \"\"\"A fixture bench whose docstring NAMES serve_qps.\"\"\"
      def emit():
        return {'metric': 'x', 'value': 1.0}
      """})
  res = run_passes(root, passes=['registry'])
  unproduced = {f.symbol for f in res.findings
                if f.rule == 'registry/artifact-key-unproduced'}
  assert 'serve_qps' in unproduced and 'lint_waivers' in unproduced
  assert 'metric' not in unproduced and 'value' not in unproduced
  (tmp_path / PKG / 'bench.py').write_text(
      "def emit():\n  return {'metric': 'x', 'value': 1.0,"
      " 'serve_qps': 2.0}\n")
  res2 = run_passes(root, passes=['registry'])
  unproduced2 = {f.symbol for f in res2.findings
                 if f.rule == 'registry/artifact-key-unproduced'}
  assert 'serve_qps' not in unproduced2 and 'lint_waivers' in unproduced2
  # a tree without the port's bench arms nothing
  (tmp_path / PKG / 'bench.py').unlink()
  (tmp_path / 'bench.py').write_text("def emit():\n  return {}\n")
  assert not run_passes(root, passes=['registry']).findings


# --------------------------------------------------------- concurrency

CONCURRENCY_FIXTURES = {
    'lock_order_cycle': {'bad.py': """
        import threading

        _a = threading.Lock()
        _b = threading.Lock()

        def path_one():
          with _a:
            with _b:
              pass

        def path_two():
          with _b:
            with _a:
              pass
        """},
    'call_mediated_cycle': {
        'mod_a.py': """
        import threading
        from {pkg} import mod_b

        _a = threading.Lock()

        def use_a_then_b():
          with _a:
            mod_b.take_b()

        def take_a():
          with _a:
            pass
        """,
        'mod_b.py': """
        import threading
        from {pkg} import mod_a

        _b = threading.Lock()

        def use_b_then_a():
          with _b:
            mod_a.take_a()

        def take_b():
          with _b:
            pass
        """},
    'multi_item_with': {'bad.py': """
        import threading

        _a = threading.Lock()
        _b = threading.Lock()

        def path_one():
          with _a, _b:
            pass

        def path_two():
          with _b:
            with _a:
              pass
        """},
    'thread_closure': {'ok.py': """
        import threading

        _a = threading.Lock()
        _b = threading.Lock()

        def start_worker():
          def worker():
            with _a:
              pass
          t = threading.Thread(target=worker, daemon=True)
          t.start()
          return t

        def under_b():
          with _b:
            t = start_worker()
            t.join()

        def legit_order():
          with _a:
            with _b:
              pass
        """},
    'blocking_put': {'bad.py': """
        import queue
        import threading

        class Pipe:
          def __init__(self):
            self._lock = threading.Lock()
            self._q = queue.Queue(maxsize=2)
            self._t = threading.Thread(target=self._run, daemon=True)
            self._t.start()

          def _run(self):
            pass

          def push(self, item):
            with self._lock:
              self._q.put(item)
        """},
    'timed_put_joined': {'good.py': """
        import queue
        import threading

        class Pipe:
          def __init__(self):
            self._lock = threading.Lock()
            self._q = queue.Queue(maxsize=2)
            self._t = threading.Thread(target=self._run, daemon=True)
            self._t.start()

          def _run(self):
            pass

          def push(self, item):
            self._q.put(item, timeout=0.5)

          def close(self):
            self._t.join(timeout=5.0)
        """},
    'silent_except': {'bad.py': """
        def teardown():
          try:
            risky()
          except Exception:
            pass

        def risky():
          raise ValueError
        """},
}

# rules each fixture must raise (None: none at all)
CONCURRENCY_WANT = {
    'lock_order_cycle': {'concurrency/lock-order-cycle'},
    'call_mediated_cycle': {'concurrency/lock-order-cycle'},
    'multi_item_with': {'concurrency/lock-order-cycle'},
    'thread_closure': None,
    'blocking_put': {'concurrency/blocking-queue-under-lock',
                     'concurrency/untimed-put-bounded',
                     'concurrency/thread-no-join'},
    'timed_put_joined': None,
    'silent_except': {'concurrency/silent-except'},
}


def _concurrency_tree(tmp_path, case, pkg):
  return _tree(tmp_path, {f'{pkg}/{name}': src.replace('{pkg}', pkg)
                          for name, src in CONCURRENCY_FIXTURES[case].items()})


@pytest.mark.parametrize('case', sorted(CONCURRENCY_FIXTURES))
def test_fixture_concurrency(tmp_path, case):
  res = run_passes(_concurrency_tree(tmp_path, case, PKG),
                   passes=['concurrency'])
  want = CONCURRENCY_WANT[case]
  if want is None:
    assert not res.findings, [f.brief() for f in res.findings]
  else:
    assert want <= _rules(res), [f.brief() for f in res.findings]
  if case == 'lock_order_cycle':
    hit = next(f for f in res.findings
               if f.rule == 'concurrency/lock-order-cycle')
    assert '_a' in hit.message and '_b' in hit.message
    assert _cli(str(tmp_path), tmp_path, '--passes', 'concurrency') == 1
  if case == 'silent_except':
    assert [f.symbol for f in res.findings] == ['teardown#0']


@pytest.mark.parametrize('case', sorted(CONCURRENCY_FIXTURES))
def test_concurrency_ids_equal_jax(tmp_path, case):
  """The same fixture under each package's tree: the JAX package's
  ``run_passes`` and the port's give the same finding ids, the package
  directory in the path aside."""
  jroot = _concurrency_tree(tmp_path / 'jax', case,
                            'distributed_embeddings_tpu')
  proot = _concurrency_tree(tmp_path / 'port', case, PKG)
  jids = sorted(f.id.replace('distributed_embeddings_tpu/', f'{PKG}/')
                for f in jax_core.run_passes(jroot, passes=['concurrency'])
                .findings)
  pids = sorted(f.id for f in run_passes(proot, passes=['concurrency'])
                .findings)
  assert jids == pids
  assert bool(pids) == (CONCURRENCY_WANT[case] is not None)


# --------------------------------------------------------------- purity


def test_fixture_rng_in_autograd_function(tmp_path):
  root = _tree(tmp_path, {f'{PKG}/bad.py': """
      import torch

      class Noisy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
          return x + torch.randn(x.shape)

        @staticmethod
        def backward(ctx, g):
          return g
      """})
  res = run_passes(root, passes=['purity'])
  hits = [f for f in res.findings
          if f.rule == 'purity/host-effect-in-traced']
  assert [f.symbol for f in hits] == \
      ['Noisy.forward->Noisy.forward:global-rng:torch.randn']
  assert res.meta['purity']['roots'] == 2
  assert _cli(root, tmp_path, '--passes', 'purity') == 1


def test_fixture_file_io_in_a_returned_step(tmp_path):
  """A ``make_*`` factory's returned step, the effect one call deep, and
  a returned lambda."""
  root = _tree(tmp_path, {f'{PKG}/bad.py': """
      import numpy as np

      def helper(x):
        with open('/dev/null', 'w') as f:
          f.write('x')
        return x

      def make_step(lr):
        def step(state, batch):
          return helper(state) + lr
        return step

      def make_noisy_trainer():
        return lambda s: s + np.random.normal()
      """})
  res = run_passes(root, passes=['purity'])
  syms = {f.symbol for f in res.findings}
  assert 'make_step.step->helper:file-io:open' in syms
  assert any(s.startswith('make_noisy_trainer.<lambda@')
             and s.endswith('global-rng:numpy.random.normal')
             for s in syms), syms


def test_fixture_sanctioned_effects_are_clean(tmp_path):
  """Eager code may time, journal, count and trace on every call, and a
  draw from a given generator or a seeded numpy Generator is no global
  draw."""
  root = _tree(tmp_path, {f'{PKG}/okay.py': f"""
      import time

      import numpy as np
      import torch

      from {PKG}.obs import metrics as obs_metrics
      from {PKG}.obs import trace as obs_trace
      from {PKG}.utils import resilience

      class Seeded(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, gen):
          t0 = time.perf_counter()
          with obs_trace.span('fwd/exchange'):
            obs_metrics.inc('train.steps')
            resilience.journal('io_retry', t=t0)
            rng = np.random.default_rng(0)
            return x + torch.randn(x.shape, generator=gen) + rng.random()
      """})
  res = run_passes(root, passes=['purity'])
  assert not res.findings, [f.brief() for f in res.findings]
  assert res.meta['purity']['roots'] == 1


# ------------------------------------------------------------- docdrift

_README = """
    # repo

    ## Quick start

    `NoSuchSymbol.here` is outside the port's section: not checked.

    ## PyTorch/CUDA port

    `Engine.lookup` and `tool.main` resolve; `Engine.vanished` and
    `tool.renamed` do not; `torch.cuda.foo` is not the port's.
    See design.md §1 and design.md §9.

    ```bash
    python -m {pkg}.tool --real_flag \\
        --flag_that_was_renamed
    timeout --kill-after=10 900 python -m {pkg}.tool --real_flag
    ```

    ## Another section
    """


def test_fixture_docdrift(tmp_path):
  root = _tree(tmp_path, {
      'README.md': _README.replace('{pkg}', PKG),
      f'{PKG}/tool.py': """
          import argparse

          class Engine:
            def lookup(self):
              pass

          def main():
            ap = argparse.ArgumentParser()
            ap.add_argument('--real_flag', action='store_true')
            return ap.parse_args()
          """,
      f'{PKG}/other.py': '# see design.md §7, a section that is gone\n',
      'docs/design.md': """
          # design

          ## 1. the only section
          """})
  res = run_passes(root, passes=['docdrift'])
  by_rule = {}
  for f in res.findings:
    by_rule.setdefault(f.rule, []).append(f.symbol)
  assert sorted(by_rule['docdrift/api-symbol-unresolved']) == \
      ['Engine.vanished', 'tool.renamed']
  assert by_rule['docdrift/cli-flag-unknown'] == \
      [f'{PKG}.tool:--flag_that_was_renamed']
  assert sorted(by_rule['docdrift/dangling-section-ref']) == ['§7', '§9']
  assert res.meta['docdrift_api_symbols'] == 4
  assert res.meta['docdrift_cli_flags'] == 3
  assert _cli(root, tmp_path, '--passes', 'docdrift') == 1


# ------------------------------------------------- ids and waiver policy

_SWALLOW = """
    def teardown():
      try:
        risky()
      except Exception:
        pass

    def risky():
      raise ValueError
    """


def test_finding_id_is_line_stable(tmp_path):
  root = _tree(tmp_path, {f'{PKG}/bad.py': _SWALLOW})
  id0 = run_passes(root, passes=['concurrency']).findings[0].id
  (pathlib.Path(root) / PKG / 'bad.py').write_text(
      '# filler\n' * 40 + textwrap.dedent(_SWALLOW))
  res = run_passes(root, passes=['concurrency'])
  assert res.findings[0].id == id0
  assert res.findings[0].line > 40


def test_waiver_requires_rationale(tmp_path):
  bad = tmp_path / 'base.toml'
  bad.write_text('[[waiver]]\nid = "concurrency/silent-except@x::y#0"\n')
  with pytest.raises(BaselineError, match='no rationale'):
    Baseline.load(str(bad))
  root = _tree(tmp_path, {f'{PKG}/bad.py': _SWALLOW})
  assert detlint.main(['--root', root, '--baseline', str(bad)]) == 2


def test_waiver_suppresses_and_stale_fails_strict(tmp_path):
  root = _tree(tmp_path, {f'{PKG}/bad.py': _SWALLOW})
  fid = run_passes(root, passes=['concurrency']).findings[0].id
  base = tmp_path / 'base.toml'
  base.write_text(
      f'[[waiver]]\nid = "{fid}"\n'
      'rationale = "fixture: deliberately swallowed"\n'
      '[[waiver]]\nid = "concurrency/silent-except@gone.py::dead#0"\n'
      'rationale = "stale on purpose"\n')
  args = ['--root', root, '--baseline', str(base), '--passes', 'concurrency']
  assert detlint.main(args) == 0
  assert detlint.main(args + ['--strict']) == 3


def test_unknown_pass_refuses():
  with pytest.raises(ValueError, match='unknown pass'):
    run_passes(str(ROOT), passes=['no_such_pass'])


def test_expired_waiver_fails_strict_with_rationale(tmp_path):
  root = _tree(tmp_path, {f'{PKG}/bad.py': _SWALLOW})
  fid = run_passes(root, passes=['concurrency']).findings[0].id
  base = tmp_path / 'base.toml'

  def write(expires):
    base.write_text(f'[[waiver]]\nid = "{fid}"\n'
                    'rationale = "tied to an open roadmap item"\n'
                    f'expires = "{expires}"\n')

  args = ['--root', root, '--baseline', str(base), '--passes', 'concurrency']
  write('2001-01-01')
  assert detlint.main(args) == 0
  assert detlint.main(args + ['--strict']) == 3
  exp = Baseline.load(str(base)).expired({'concurrency'})
  assert len(exp) == 1 and 'open roadmap item' in exp[0]
  assert Baseline.load(str(base)).expired({'registry'}) == []
  write('2999-12-31')
  assert detlint.main(args + ['--strict']) == 0
  write('soonish')
  with pytest.raises(BaselineError, match='malformed expires'):
    Baseline.load(str(base))
  assert detlint.main(args) == 2


def test_backend_scoped_waiver(tmp_path):
  """A ``backends``-scoped waiver suppresses on every run but is stale
  only on a run of a backend it names; a malformed scope refuses."""
  base = tmp_path / 'base.toml'
  base.write_text('[[waiver]]\nid = "hostsync/x@f.py::g"\n'
                  'rationale = "seen on the card only"\n'
                  'backends = "cuda"\n')
  b = Baseline.load(str(base))
  for backend, stale in (('cuda', ['hostsync/x@f.py::g']), ('cpu', []),
                         (None, ['hostsync/x@f.py::g'])):
    res = lint_core.apply_baseline([], b, {'hostsync'}, {},
                                   backend=backend)
    assert res.stale_waivers == stale, backend
  hit = lint_core.Finding('hostsync/x', 'f.py', 0, 'g', 'm')
  res = lint_core.apply_baseline([hit], b, {'hostsync'}, {}, backend='cpu')
  assert [f.id for f in res.waived] == [hit.id] and not res.findings
  for bad in ('gpu', '', 'cpu,tpu'):
    base.write_text('[[waiver]]\nid = "hostsync/x@f.py::g"\n'
                    f'rationale = "r"\nbackends = "{bad}"\n')
    with pytest.raises(BaselineError, match='malformed backends'):
      Baseline.load(str(base))


# ------------------------------------------------ baseline parity with JAX

_BASELINE_TEXTS = {
    'waived_and_stale': (
        '[[waiver]]\nid = "concurrency/silent-except@p.py::teardown#0"\n'
        'rationale = "r"\n'
        '[[waiver]]\nid = "concurrency/silent-except@gone.py::dead#0"\n'
        'rationale = "stale"\n'
        '[[waiver]]\nid = "registry/span-unregistered@p.py::x"\n'
        'rationale = "another pass: never stale here"\n'),
    'expired': ('[[waiver]]\nid = "concurrency/silent-except@p.py::teardown#0"\n'
                'rationale = "dated"\nexpires = "2001-01-01"\n'),
    'future': ('[[waiver]]\nid = "concurrency/silent-except@p.py::teardown#0"\n'
               'rationale = "dated"\nexpires = "2999-01-01"\n'),
    'no_rationale': '[[waiver]]\nid = "concurrency/x@p.py::y"\n',
    'blank_rationale': '[[waiver]]\nid = "a/b@c::d"\nrationale = "  "\n',
    'no_id': '[[waiver]]\nrationale = "r"\n',
    'bad_expires': ('[[waiver]]\nid = "a/b@c::d"\nrationale = "r"\n'
                    'expires = "soon"\n'),
    'duplicate': ('[[waiver]]\nid = "a/b@c::d"\nrationale = "r"\n'
                  '[[waiver]]\nid = "a/b@c::d"\nrationale = "r"\n'),
    'unparseable': '[[waiver]]\nid = unquoted\n',
    'outside_table': 'id = "a/b@c::d"\n',
}


def _baseline_outcome(core_mod, path):
  try:
    b = core_mod.Baseline.load(path)
  except core_mod.BaselineError as e:
    return ('error', str(e))
  findings = [core_mod.Finding('concurrency/silent-except', 'p.py', 3,
                               'teardown#0', 'm'),
              core_mod.Finding('concurrency/silent-except', 'q.py', 9,
                               'other#0', 'm')]
  res = core_mod.apply_baseline(findings, b, {'concurrency'}, {})
  return ('ok', [f.id for f in res.findings], [f.id for f in res.waived],
          res.stale_waivers, res.expired_waivers,
          b.expired({'concurrency'}, on='2026-01-01'))


@pytest.mark.parametrize('name', sorted(_BASELINE_TEXTS))
def test_baseline_semantics_equal_jax(tmp_path, name):
  path = tmp_path / 'base.toml'
  path.write_text(_BASELINE_TEXTS[name])
  assert _baseline_outcome(lint_core, str(path)) == \
      _baseline_outcome(jax_core, str(path))


# -------------------------------------------------------------- locksan


def _acquisition_script(mod):
  with mod.capture('fixture') as cap:
    a = threading.Lock()
    b = threading.Lock()
    c = threading.RLock()
    with a:
      with b:
        pass
    with b:
      with c:
        with a:
          pass
  return cap


def test_locksan_cycle_equal_jax():
  port, jax = _acquisition_script(locksan), _acquisition_script(jax_locksan)
  assert port.find_cycle() is not None
  assert port.find_cycle() == jax.find_cycle()
  assert port.edges == jax.edges
  with pytest.raises(locksan.LockOrderError, match='lock-order cycle'):
    port.assert_acyclic()


def test_locksan_detects_inverted_acquisition_order():
  with locksan.capture('fixture') as cap:
    a = threading.Lock()
    b = threading.Lock()
    with a:
      with b:
        pass
    with b:
      with a:
        pass
  assert cap.locks_created == 2
  assert cap.find_cycle() is not None
  with pytest.raises(locksan.LockOrderError, match='lock-order cycle'):
    cap.assert_acyclic()


def test_locksan_consistent_order_is_acyclic():
  with locksan.capture() as cap:
    a = threading.Lock()
    b = threading.Lock()
    for _ in range(3):
      with a:
        with b:
          pass
  cap.assert_acyclic()
  assert len(cap.edges) == 1 and list(cap.edges.values()) == [3]


def test_locksan_ducktypes_condition_and_queue():
  with locksan.capture() as cap:
    q = queue_mod.Queue(maxsize=2)
    lk = threading.Lock()
    cond = threading.Condition(lk)
    got = []

    def worker():
      got.append(q.get(timeout=5.0))
      with cond:
        cond.notify()

    t = threading.Thread(target=worker)
    t.start()
    with cond:
      q.put('x', timeout=1.0)
      cond.wait(timeout=5.0)
    t.join(timeout=5.0)
  assert got == ['x']
  assert cap.locks_created >= 2
  cap.assert_acyclic()


def test_locksan_reentrant_rlock_records_no_self_edge():
  with locksan.capture() as cap:
    r = threading.RLock()
    with r:
      with r:
        pass
  cap.assert_acyclic()
  assert not cap.edges
  # the window restored the real factories
  assert threading.Lock is locksan._REAL_LOCK
