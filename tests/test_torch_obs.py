"""The port's copy of the obs layer (``obs/trace.py``, ``obs/metrics.py``,
``obs/__init__.py``, ``tools/trace_report.py``) against the JAX
package's: the cases of tests/test_obs.py (less the CSR feed's, item 15,
and the detlint scans, item 16), the names and output formats of both
packages, traces read by both reports, the spans and counters the
checkpoint files, the auditor, ``fit``, the step and serving emit, and a
traced step equal to an untraced one with the same kernel calls."""

import ast
import importlib.util
import json
import pathlib
import threading

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.obs import metrics as jax_metrics
from distributed_embeddings_tpu.obs import trace as jax_trace
from distributed_embeddings_tpu.utils import resilience as jax_resilience
from distributed_embeddings_tpu_torch import obs, optim, serving
from distributed_embeddings_tpu_torch.models import dlrm, synthetic
from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.ops import lookup, segwalk
from distributed_embeddings_tpu_torch.parallel import audit
from distributed_embeddings_tpu_torch.parallel import callbacks
from distributed_embeddings_tpu_torch.parallel import grad
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.tools import trace_report
from distributed_embeddings_tpu_torch.utils import resilience

import torch_parity

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / 'distributed_embeddings_tpu_torch'
# the step's four phases: trace-time spans in JAX, host work in the port
STEP_SPANS = {'fwd/exchange', 'fwd/lookup_combine', 'bwd/exchange',
              'apply/update'}


def _jax_trace_report():
  spec = importlib.util.spec_from_file_location(
      'jax_trace_report_for_torch_obs', ROOT / 'tools' / 'trace_report.py')
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _reset():
  obs.reset()
  jax_trace.disable(force=True)
  jax_trace.clear()


@pytest.fixture(autouse=True)
def _obs_isolated(tmp_path, monkeypatch):
  monkeypatch.setenv('DET_FT_JOURNAL', str(tmp_path / 'journal.jsonl'))
  resilience.clear_recent()
  _reset()
  yield
  _reset()


def test_trace_round_trip_is_valid_chrome_trace(tmp_path):
  obs_trace.enable()
  with obs_trace.span('train/step', step=1):
    t0 = obs_trace.now()
    obs_trace.complete('train/sync', t0, 0.002, step=1)
  path = obs_trace.save(str(tmp_path / 't.json'))
  with open(path, encoding='utf-8') as f:
    payload = json.load(f)
  assert payload['displayTimeUnit'] == 'ms'
  events = payload['traceEvents']
  meta = [e for e in events if e['ph'] == 'M']
  spans = {e['name']: e for e in events if e['ph'] == 'X'}
  assert meta and meta[0]['args']['name']
  assert spans['train/step']['args'] == {'step': 1}
  assert spans['train/sync']['cat'] == 'wait'
  assert abs(spans['train/sync']['dur'] - 2000.0) < 1e-6
  assert spans['train/sync']['tid'] == spans['train/step']['tid']


def test_trace_buffer_bound_counts_drops(tmp_path):
  obs_trace.enable(max_events=4)
  obs_trace.enable()  # a re-arm without max_events keeps the bound
  for k in range(10):
    with obs_trace.span('train/step', step=k):
      pass
  assert obs_trace.event_count() <= 4 and obs_trace.dropped() > 0
  path = obs_trace.save(str(tmp_path / 't.json'))
  with open(path, encoding='utf-8') as f:
    assert json.load(f)['otherData']['dropped_events'] > 0


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_histogram_percentiles_match_the_jax_histogram(seed):
  """The fixed-bucket bounds bracket the exact percentile and equal the
  JAX package's histogram's on the same samples."""
  rng = np.random.default_rng(seed)
  data = np.abs(rng.lognormal(mean=seed, sigma=1.5, size=4000))
  h, jh = obs_metrics.Histogram(), jax_metrics.Histogram()
  for v in data:
    h.observe(v)
    jh.observe(v)
  for p in (50, 90, 99):
    exact = float(np.percentile(data, p, method='inverted_cdf'))
    lo, hi = h.percentile_bounds(p)
    assert lo <= exact <= hi
    assert (lo, hi) == jh.percentile_bounds(p) and h.percentile(p) == hi
  assert h.to_dict() == jh.to_dict()
  empty = obs_metrics.Histogram()
  assert empty.percentile(50) is None and empty.percentile_bounds(99) is None


def test_registry_snapshot_and_journal(tmp_path):
  obs_metrics.enable()
  obs_metrics.inc('train.steps', 5)
  obs_metrics.set_gauge('train.loss', 0.25)
  obs_metrics.observe('audit.call_ms', 12.0)
  snap = obs_metrics.snapshot()
  assert snap['train.steps'] == 5.0 and snap['train.loss'] == 0.25
  assert snap['audit.call_ms']['count'] == 1
  ev = obs_metrics.journal_snapshot(step=7)
  assert ev['kind'] == 'metrics_snapshot' and ev['step'] == 7
  with open(tmp_path / 'journal.jsonl', encoding='utf-8') as f:
    assert json.loads(f.readlines()[-1])['metrics']['train.steps'] == 5.0
  with pytest.raises(KeyError, match='unregistered metric'):
    obs_metrics.inc('train.stpes')
  with pytest.raises(TypeError, match='is a counter'):
    obs_metrics.observe('train.steps', 1.0)


def test_disabled_spans_and_counters_are_noops(tmp_path):
  assert obs_trace.span('train/step', step=1) is obs_trace.span('ckpt/save')
  obs_trace.complete('train/sync', 0.0, 1.0)
  assert obs_trace.event_count() == 0
  obs_metrics.inc('train.steps')
  obs_metrics.observe('audit.call_ms', 1.0)
  assert obs_metrics.snapshot() == {}
  assert obs_metrics.journal_snapshot(step=1) is None
  assert not (tmp_path / 'journal.jsonl').exists()


def _literals(fn_names, owner=None):
  """``(file, name, literal)`` of every string literal passed first to a
  call of one of ``fn_names`` in the port's sources (``owner``: only
  ``owner.fn(...)`` calls, and bare calls in ``owner``'s own file)."""
  found = []
  for path in sorted(PORT.rglob('*.py')):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
      if not isinstance(node, ast.Call) or not node.args:
        continue
      f = node.func
      if isinstance(f, ast.Attribute):
        name = f.attr
        if owner and getattr(f.value, 'id', None) != owner:
          continue
      else:
        name = getattr(f, 'id', None)
        if owner and path.stem != owner:
          continue
      arg = node.args[0]
      if name in fn_names and isinstance(arg, ast.Constant) and isinstance(
          arg.value, str):
        found.append((path.name, name, arg.value))
  return found


def test_span_metric_and_event_names_registered():
  """Every span, metric and journal event of the port is registered, and
  every journal event name is the JAX package's."""
  spans = [v for _, n, v in _literals({'span', 'complete', 'begin',
                                       'instant'})]
  metrics = [v for _, n, v in _literals({'inc', 'observe', 'set_gauge'})]
  events = [v for _, n, v in _literals({'journal'}, owner='resilience')]
  assert {'train/step', 'train/sync', 'ckpt/save', 'ckpt/restore',
          'audit/check'} | STEP_SPANS | obs_trace.PORT_SPANS <= set(spans) \
      <= obs_trace.REGISTERED_SPANS
  assert set(metrics) <= obs_metrics.REGISTERED_METRICS and metrics
  assert set(events) <= resilience.REGISTERED_EVENTS
  assert {'rollback', 'checkpoint_quarantined', 'audit_failure'} <= set(
      events)
  assert resilience.REGISTERED_EVENTS <= jax_resilience.REGISTERED_EVENTS
  assert all(jax_metrics.METRIC_TYPES[k] == t
             for k, t in obs_metrics.METRIC_TYPES.items()
             if k not in obs_metrics.PORT_METRICS)


def test_fit_emits_its_spans_and_counters(tmp_path):
  """One armed ``fit`` with a checkpoint callback and an auditor records
  the step, sync, save and audit spans and their counters."""
  dist = DistributedEmbedding([TableConfig(20, 4, combiner='sum')],
                              device='cpu')
  rng = np.random.default_rng(0)
  kernel = torch.tensor(rng.normal(size=(4, 1)).astype(np.float32))

  def head(dense, outs, y):
    return torch.mean((outs[0] @ dense['kernel'] - y) ** 2)

  emb_opt = sparse.SparseAdagrad(0.05)
  step = sparse.make_hybrid_train_step(dist, head, optim.sgd(0.05), emb_opt)
  state = sparse.init_hybrid_train_state(
      dist, {'embedding': dist.init(0), 'kernel': kernel}, optim.sgd(0.05),
      emb_opt)
  data = [([rng.integers(0, 20, (8, 2)).astype(np.int32)],
           torch.ones(8, 1)) for _ in range(4)]
  obs_trace.enable()
  obs_metrics.enable()
  grad.fit(step, state, iter(data), steps=4, log_every=2, verbose=False,
           callbacks=[callbacks.CheckpointCallback(
               dist, str(tmp_path / 'c_{step}.npz'), every=2)],
           auditor=audit.StateAuditor(dist, every=1))
  evs = [e for e in obs_trace.events() if e['ph'] == 'X']
  names = [e['name'] for e in evs]
  assert names.count('train/step') == 4 and names.count('train/sync') == 2
  assert names.count('ckpt/save') == 2 and names.count('audit/check') == 4
  # one train/step a step, from the step function, its phases inside
  steps = [e for e in evs if e['name'] == 'train/step']
  assert [e['args']['step'] for e in steps] == [1, 2, 3, 4]
  for e in evs:
    if e['name'] in ('fwd/inputs', 'apply/update', 'dense/update'):
      assert sum(_inside(e, s) for s in steps) == 1, e
  snap = obs_metrics.snapshot()
  assert snap['train.steps'] == 4 and snap['ckpt.saves'] == 2
  assert snap['audit.calls'] == 4 and snap['ckpt.save_ms']['count'] == 2
  assert resilience.recent('metrics_snapshot')
  # a step function of the caller's own records no train/step
  obs_trace.clear()
  grad.fit(lambda st, x: (st, torch.zeros(())), state, [(0,)] * 3,
           steps=3, log_every=3, verbose=False)
  names = [e['name'] for e in obs_trace.events() if e['ph'] == 'X']
  assert names == ['train/sync']


def _inside(inner, outer) -> bool:
  """Whether span event ``inner`` lies within ``outer`` on its track."""
  return (inner['tid'] == outer['tid'] and outer['ts'] <= inner['ts']
          and inner['ts'] + inner['dur'] <= outer['ts'] + outer['dur'])


# ----------------------------------------------- the JAX package's names


def test_registered_names_match_the_jax_package():
  """Spans are JAX's less the CSR feed's (item 15) plus the port's own
  (``PORT_SPANS``, none of them JAX's), metrics JAX's less the feed's
  plus the port's own (``PORT_METRICS``, none of them JAX's);
  the categories agree but for the step's four phases, host work in the
  port and trace-time spans in JAX, and the port's own are host work."""
  feed = {n for n in jax_trace.REGISTERED_SPANS if n.startswith('feed/')}
  assert not obs_trace.PORT_SPANS & jax_trace.REGISTERED_SPANS
  assert obs_trace.REGISTERED_SPANS == (
      (jax_trace.REGISTERED_SPANS - feed) | obs_trace.PORT_SPANS)
  feed_m = {n for n in jax_metrics.REGISTERED_METRICS
            if n.startswith('feed.')}
  assert not set(obs_metrics.PORT_METRICS) & jax_metrics.REGISTERED_METRICS
  assert obs_metrics.REGISTERED_METRICS == (
      (jax_metrics.REGISTERED_METRICS - feed_m)
      | set(obs_metrics.PORT_METRICS))
  assert obs_metrics.METRIC_TYPES == {
      **{k: v for k, v in jax_metrics.METRIC_TYPES.items()
         if k not in feed_m}, **obs_metrics.PORT_METRICS}
  differ = {n for n in obs_trace.REGISTERED_SPANS
            if obs_trace.span_category(n) != jax_trace.span_category(n)}
  assert differ == STEP_SPANS
  assert {obs_trace.span_category(n)
          for n in STEP_SPANS | obs_trace.PORT_SPANS} == {'host'}
  assert obs.__all__ == ['trace', 'metrics', 'devprof', 'REGISTERED_SPANS',
                         'REGISTERED_METRICS', 'enable', 'disable', 'reset']


def _every_shape(path):
  """One trace of every event shape the tracer writes, on two threads."""
  obs.enable(trace_path=path)
  with obs_trace.span('train/step', step=1):
    tok = obs_trace.begin('fwd/exchange', chunks=2)
    obs_trace.end(tok)
    with obs_trace.span('audit/check'):
      pass
  obs_trace.complete('coldtier/wait', obs_trace.now() - 0.003, 0.003, seq=0)
  obs_trace.async_span('serve/enqueue', 42, obs_trace.now() - 0.001,
                       obs_trace.now(), samples=2)
  obs_trace.instant('train/step', note='marker')
  obs_trace.complete('dev/fwd/exchange', obs_trace.now(), 0.001,
                     tid=obs_trace.device_tid(), direct=True)
  t = threading.Thread(target=lambda: obs_trace.complete(
      'coldtier/prepass', obs_trace.now(), 0.001), name='producer')
  t.start()
  t.join(timeout=10)
  assert not t.is_alive()
  return obs_trace.save()


def test_port_trace_loads_in_both_reports(tmp_path):
  """A trace the port writes (to its enabled path) loads in JAX's
  tools/trace_report.py and the port's, both accepting it under
  --strict with the same analysis."""
  path = _every_shape(str(tmp_path / 'trace.json'))
  assert path == str(tmp_path / 'trace.json')
  with open(path, encoding='utf-8') as f:
    payload = json.load(f)
  assert payload['otherData']['producer'] == \
      'distributed_embeddings_tpu_torch.obs.trace'
  meta = {e['args']['name'] for e in payload['traceEvents']
          if e['ph'] == 'M'}
  assert {'producer', 'device'} <= meta
  jtr = _jax_trace_report()
  assert jtr.main([path, '--strict']) == 0
  assert trace_report.main([path, '--strict', '--require',
                            'train/step,fwd/exchange,serve/enqueue']) == 0
  assert trace_report.report(trace_report.load_trace(path)) == jtr.report(
      jtr.load_trace(path))


def test_both_reports_agree_on_a_jax_trace(tmp_path, capsys):
  """On a trace the JAX package wrote, the two reports print the same
  phase table, steps and critical path (each event carries its
  category)."""
  jax_trace.enable()
  for k in range(2):
    with jax_trace.span('train/step', step=k + 1):
      for name in sorted(STEP_SPANS):
        jax_trace.end(jax_trace.begin(name))
      jax_trace.complete('train/sync', jax_trace.now(), 0.001)
  jax_trace.async_span('serve/enqueue', 1, jax_trace.now() - 0.002,
                       jax_trace.now())
  path = jax_trace.save(str(tmp_path / 'jax.json'))
  jtr = _jax_trace_report()
  want = jtr.report(jtr.load_trace(path))
  got = trace_report.report(trace_report.load_trace(path))
  assert got == want
  assert {got['phases'][n]['cat'] for n in STEP_SPANS} == {'trace'}
  assert trace_report.main([path, '--strict']) == 0
  port_text = capsys.readouterr().out
  assert jtr.main([path, '--strict']) == 0
  assert capsys.readouterr().out == port_text


def test_prometheus_text_and_digest_match_jax():
  """The same recorded values give JAX's Prometheus text and digest;
  identical recordings digest identically."""
  def record(m):
    m.enable()
    m.reset()
    m.inc('train.steps', 5)
    m.set_gauge('train.loss', 0.25)
    for v in (12.0, 0.004, 75000.0):
      m.observe('audit.call_ms', v)
    m.inc('devprof.runs')
    m.observe('devprof.phase_ms', 1.5)

  record(obs_metrics)
  record(jax_metrics)
  try:
    text = obs_metrics.prometheus_text()
    assert text == jax_metrics.prometheus_text()
    assert obs_metrics.snapshot_digest() == jax_metrics.snapshot_digest()
    assert '# TYPE det_train_steps counter' in text
    assert 'det_audit_call_ms_bucket{le="+Inf"} 3' in text
    assert 'det_devprof_phase_ms_count 1' in text
    d1 = obs_metrics.snapshot_digest()
    record(obs_metrics)
    assert obs_metrics.snapshot_digest() == d1
    obs_metrics.reset()
    assert obs_metrics.prometheus_text() == ''
  finally:
    jax_metrics.disable()
    jax_metrics.reset()


def test_histogram_empty_and_reset():
  h = obs_metrics.Histogram()
  assert h.percentile(50) is None and h.percentile_bounds(99) is None
  h.observe(3.0)
  assert h.percentile(50) == 3.0  # clamped to the observed max
  h.reset()
  assert h.count == 0 and h.percentile(50) is None


def test_overlap_stat_matches_jax():
  """The hidden share as JAX's ``OverlapStat`` computes it (its
  percentage form is the CSR feed's, item 15)."""
  ov, jov = obs_metrics.OverlapStat(), jax_metrics.OverlapStat()
  assert ov.overlap_frac() == jov.overlap_frac() == 0.0
  for build, blocked in ((10.0, 2.5), (0.0, 100.0)):  # then clamps at 0
    for o in (ov, jov):
      o.add_build(build)
      o.add_blocked(blocked)
      o.count_batch()
    assert ov.overlap_frac() == jov.overlap_frac()
  assert ov.batches == 2 and ov.overlap_frac() == 0.0


def test_latency_window_trims_and_matches_numpy():
  w = obs_metrics.LatencyWindow(cap=100, keep=50)
  vals = list(np.random.default_rng(0).uniform(1, 50, size=80))
  w.extend(vals)
  assert w.percentile(50) == pytest.approx(float(np.percentile(vals, 50)))
  w.extend(list(range(30)))  # 110 > cap: the last 50 kept
  assert len(w) == 50 and w.percentile(99) is not None


# ---------------------------------------------------------- the tracer


def test_disabled_path_allocates_nothing(tmp_path):
  assert obs_trace.begin('fwd/exchange') is None
  for name in obs_trace.PORT_SPANS:
    assert obs_trace.begin(name) is None
    assert obs_trace.span(name) is obs_trace.span('train/step')
  obs_trace.end(None)
  # a disarmed step, every new site included, records nothing
  step, state, batches = _tiny_trainer(0)
  step(state, *batches[0])
  obs_trace.async_span('serve/enqueue', 1, 0.0, 1.0)
  obs_trace.instant('train/step')
  assert obs_trace.device_tid() == 0
  assert obs_trace.event_count() == 0
  with pytest.raises(ValueError, match='needs a path'):
    obs_trace.save()
  with pytest.raises(ValueError, match='needs a path'):
    obs_trace.save_rotating()


def test_measure_overhead_leaves_no_residue():
  out = obs.measure_overhead(100.0, reps=200)
  assert out['obs_step_call_us'] > 0
  assert 0 <= out['obs_overhead_pct'] < 2.0
  assert not obs_trace.enabled() and not obs_metrics.enabled()
  assert all(e['ph'] == 'M' for e in obs_trace.events())
  assert obs_trace.dropped() == 0
  assert obs_metrics.snapshot().get('train.steps', 0.0) == 0.0
  obs.enable()
  with obs_trace.span('train/step', step=1):
    pass
  evs = obs_trace.events()
  assert {e['tid'] for e in evs if e['ph'] == 'X'} <= {
      e['tid'] for e in evs if e['ph'] == 'M'}


def test_truncate_keeps_labels_and_restores_drops():
  obs_trace.enable(max_events=3)
  with obs_trace.span('train/step'):
    pass
  n0, d0 = obs_trace.event_count(), obs_trace.dropped()

  def other():
    for _ in range(3):
      obs_trace.instant('train/step')

  t = threading.Thread(target=other, name='late')
  t.start()
  t.join(timeout=10)
  assert obs_trace.dropped() > d0
  obs_trace.truncate(n0, dropped_to=d0)
  evs = obs_trace.events()
  assert obs_trace.dropped() == d0 and len(evs) == n0 + 1
  assert evs[-1]['ph'] == 'M' and evs[-1]['args']['name'] == 'late'


def test_enable_pin_survives_nested_disable():
  obs_trace.enable(pin=True)
  assert obs_trace.disable() is False and obs_trace.enabled()
  obs_trace.unpin()
  obs_trace.unpin()  # floored at 0
  assert obs_trace.disable() is True and not obs_trace.enabled()
  obs_trace.enable(pin=True)
  assert obs_trace.disable(force=True) is True
  assert not obs_trace.enabled()


def test_save_rotating_segments_keep_head_and_labels(tmp_path):
  obs_trace.enable(path=str(tmp_path / 'rot.json'))
  assert obs_trace.save_rotating(max_events=5) is None  # below
  for k in range(5):
    with obs_trace.span('train/step', step=k):
      pass
  seg0 = obs_trace.save_rotating(max_events=5)
  assert seg0.endswith('rot.seg0000.json')
  ev0 = trace_report.load_trace(seg0)
  assert [e['args']['step'] for e in ev0 if e['ph'] == 'X'] == [0, 1, 2, 3, 4]
  assert all(e['ph'] == 'M' for e in obs_trace.events())
  for k in range(5, 10):
    with obs_trace.span('train/step', step=k):
      pass
  seg1 = obs_trace.save_rotating(max_events=5)
  ev1 = trace_report.load_trace(seg1)
  assert [e['args']['step'] for e in ev1 if e['ph'] == 'X'] == [5, 6, 7, 8, 9]
  assert {e['tid'] for e in ev1 if e['ph'] == 'X'} <= {
      e['tid'] for e in ev1 if e['ph'] == 'M'}
  assert obs_trace.segment_count() == 2
  with open(seg1, encoding='utf-8') as f:
    assert json.load(f)['otherData']['segment'] == 1
  assert _jax_trace_report().main([seg1, '--strict']) == 0


def test_save_rotating_flushes_a_bound_limited_buffer(tmp_path):
  obs_trace.enable(max_events=6)
  path = str(tmp_path / 'bound.json')
  for k in range(10):
    with obs_trace.span('train/step', step=k):
      pass
  assert obs_trace.dropped() > 0
  assert obs_trace.save_rotating(path, max_events=100) is not None
  assert obs_trace.save_rotating(path, max_events=100) is None


def test_device_lane_round_trip_and_report_split(tmp_path):
  obs.enable()
  tid = obs_trace.device_tid()
  assert tid > 0 and obs_trace.device_tid() == tid
  base = obs_trace.now() - 0.020
  obs_trace.complete('dev/fwd/exchange', base, 0.004, tid=tid, direct=True)
  obs_trace.complete('dev/fwd/lookup_combine', base + 0.004, 0.006, tid=tid,
                     direct=False)
  obs_trace.complete('dev/apply/update', base + 0.010, 0.002, tid=tid,
                     direct=True)
  with obs_trace.span('train/step', step=1):
    pass
  path = obs_trace.save(str(tmp_path / 'dev.json'))
  events = trace_report.load_trace(path)
  dev = [e for e in events if e.get('cat') == 'device']
  assert len(dev) == 3 and {e['tid'] for e in dev} == {tid}
  assert any(e['ph'] == 'M' and e['args']['name'] == 'device'
             and e['tid'] == tid for e in events)
  cp = trace_report.report(events)['critical_path']
  assert cp['device_ms'] == pytest.approx(12.0, abs=0.5)
  assert cp['residue_ms'] <= cp['unattributed_ms'] + 1e-6
  assert trace_report.main([path, '--strict', '--require',
                            'dev/fwd/exchange,dev/apply/update']) == 0


# ------------------------------------------------------- the report


def test_trace_report_attribution_and_gates(tmp_path):
  obs.enable()
  base = obs_trace.now() - 0.1
  for k in range(3):
    with obs_trace.span('train/step', step=k + 1):
      obs_trace.end(obs_trace.begin('fwd/exchange'))
    # three disjoint 2 ms syncs, 3 ms apart: a blocked union of 6
    obs_trace.complete('train/sync', base + k * 0.003, 0.002, step=k + 1)
  # overlapping waits count once in the union
  obs_trace.complete('train/sync', base, 0.002)
  obs_trace.complete('train/sync', base + 0.001, 0.0015)
  path = obs_trace.save(str(tmp_path / 'trace.json'))
  rep = trace_report.report(trace_report.load_trace(path))
  assert rep['phases']['train/step']['count'] == 3
  assert [s['step'] for s in rep['steps']] == [1, 2, 3]
  assert all('fwd/exchange' in s['phases'] for s in rep['steps'])
  assert rep['critical_path']['blocked_ms'] == pytest.approx(6.5, abs=0.5)
  assert rep['phases']['train/sync']['count'] == 5
  assert rep['unregistered'] == []
  text = trace_report.format_report(rep)
  assert 'per-step breakdown' in text and 'train/step' in text
  assert trace_report.main([path]) == 0
  assert trace_report.main([path, '--require',
                            'train/step,fwd/exchange']) == 0
  assert trace_report.main([path, '--require', 'coldtier/fetch']) == 4
  assert trace_report.main([path, '--json']) == 0


def test_trace_report_rejects_malformed_truncated_and_unregistered(
    tmp_path, capsys):
  def case(name, payload):
    p = tmp_path / name
    p.write_text(payload if isinstance(payload, str)
                 else json.dumps(payload))
    return str(p)

  assert trace_report.main([case('garbage.json', 'not json')]) == 2
  assert trace_report.main([case('wrong.json', {'events': []})]) == 2
  obs.enable()
  with obs_trace.span('train/step', step=1):
    pass
  full = pathlib.Path(obs_trace.save(str(tmp_path / 'full.json')))
  trunc = tmp_path / 'trunc.json'
  trunc.write_bytes(full.read_bytes()[:120])
  assert trace_report.main([str(trunc)]) == 2
  assert trace_report.main([case('negdur.json', {'traceEvents': [
      {'name': 'train/step', 'ph': 'X', 'ts': 0, 'dur': -5, 'pid': 1,
       'tid': 1}]})]) == 2
  assert trace_report.main([case('dangling.json', {'traceEvents': [
      {'name': 'serve/enqueue', 'ph': 'b', 'id': '1', 'ts': 0, 'pid': 1,
       'tid': 1}]})]) == 2
  unreg = case('unreg.json', {'traceEvents': [
      {'name': 'my/custom', 'ph': 'X', 'ts': 0, 'dur': 1, 'pid': 1,
       'tid': 1}]})
  assert trace_report.main([unreg]) == 0
  assert 'WARNING: unregistered span name(s): my/custom' in \
      capsys.readouterr().out
  assert trace_report.main([unreg, '--strict']) == 3
  assert 'trace_report: STRICT:' in capsys.readouterr().err


# ------------------------------------------- the step and serving, traced


def _nesting_ok(events, eps_us=2.0):
  """X events of each (pid, tid) track are disjoint or nested."""
  tracks = {}
  for ev in events:
    if ev.get('ph') == 'X':
      tracks.setdefault((ev['pid'], ev['tid']), []).append(
          (float(ev['ts']), float(ev['ts']) + float(ev['dur']), ev['name']))
  for track in tracks.values():
    track.sort()
    stack = []
    for ts, te, name in track:
      while stack and ts >= stack[-1][1] - eps_us:
        stack.pop()
      if stack and te > stack[-1][1] + eps_us:
        return False, (name, ts, te, stack[-1])
      stack.append((ts, te, name))
  return True, None


def test_concurrent_batcher_spans_nest_under_fuzzed_submission(tmp_path):
  """8 threads of fuzzed request sizes through a live DynamicBatcher,
  traced: the trace is valid, every X track nests, every enqueue has its
  end, and the span counts reconcile with the batcher's stats."""
  cfgs = [TableConfig(48, 8, 'sum'), TableConfig(32, 8, 'sum')]
  rng = np.random.default_rng(0)
  weights = [(rng.normal(size=(c.input_dim, c.output_dim)) * 0.1)
             .astype(np.float32) for c in cfgs]
  engine = serving.ServingEngine(cfgs, weights, batch_size=16, device='cpu')
  engine.warmup()
  obs.enable()
  n_threads, per_thread = 8, 5
  errors = []

  def client(seed):
    r = np.random.default_rng(seed)
    try:
      for _ in range(per_thread):
        n = int(r.integers(1, 5))
        cats = [r.integers(0, c.input_dim, size=(n,)).astype(np.int32)
                for c in cfgs]
        out = bat.submit(cats).result(timeout=60.0)
        assert out[0].shape == (n, 8)
    except BaseException as e:  # surfaced after the join
      errors.append(e)

  with serving.DynamicBatcher(engine, max_delay_ms=1.0) as bat:
    threads = [threading.Thread(target=client, args=(s,), name=f'c{s}')
               for s in range(n_threads)]
    for t in threads:
      t.start()
    for t in threads:
      t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    stats = bat.stats()
  assert not errors, errors
  path = obs_trace.save(str(tmp_path / 'serve_trace.json'))
  events = trace_report.load_trace(path)
  ok, bad = _nesting_ok(events)
  assert ok, f'partial-overlap X spans on one track: {bad}'
  counts = {}
  for ev in events:
    if ev.get('ph') in ('X', 'b'):
      counts[ev['name']] = counts.get(ev['name'], 0) + 1
  total = n_threads * per_thread
  assert counts['serve/submit'] == counts['serve/enqueue'] == total
  assert counts['serve/demux'] == counts['serve/execute'] == stats['batches']
  assert counts['serve/lookup'] == stats['batches']
  assert stats['completed'] == total
  # the JAX package's report: every name its own but the ids' copies
  # to the device and the route stage, the port's own spans
  jtr = _jax_trace_report()
  assert jtr.report(jtr.load_trace(path))['unregistered'] == [
      'fwd/inputs', 'fwd/route']
  assert jtr.main([path]) == 0


def _tiny_trainer(seed):
  """The tiny model's training configuration (SparseAdagrad, optax-style
  Adagrad on the MLP, mean BCE) at reduced rows, drawn from ``seed``."""
  cfg = torch_parity.reduced(synthetic, 'tiny', 300)
  model = synthetic.SyntheticModel(cfg, dp_input=True, device='cpu').init(
      seed)
  dist = model.dist_embedding
  dense_opt = optim.adagrad(0.01, initial_accumulator_value=0.1, eps=1e-7)
  emb_opt = sparse.SparseAdagrad(0.01)
  state = sparse.init_hybrid_train_state(
      dist, {'embedding': model.embedding_params, **model.dense_params()},
      dense_opt, emb_opt)

  def head_loss(dense_params, emb_outs, batch):
    numerical, labels = batch
    return dlrm.bce_with_logits(model.head(numerical, emb_outs,
                                           dense_params), labels)

  step = sparse.make_hybrid_train_step(dist, head_loss, dense_opt, emb_opt)
  gen = synthetic.InputGenerator(cfg, 64, alpha=1.05, num_batches=2, seed=1)
  batches = [(torch_parity.padded_cats(cats, model.hotness, seed=i),
              (num, labels)) for i, ((num, cats), labels) in enumerate(gen)]
  return step, state, batches


def test_traced_step_equals_untraced(monkeypatch):
  """Two hybrid steps of the tiny configuration traced and untraced from
  the same draw: bit-equal losses and tables, the same lookup and
  segment-walk calls (the plain versions here; the kernels' launches on
  the card), each step's spans (its own ``train/step`` and every phase,
  the port's own among them) once a step, and no span carries a tensor
  argument."""
  calls = {'lookup': 0, 'segwalk': 0}
  real_lookup, real_apply = lookup._forward, segwalk.apply_segments

  def count(key, fn):
    def counted(*a, **k):
      calls[key] += 1
      return fn(*a, **k)
    return counted

  monkeypatch.setattr(lookup, '_forward', count('lookup', real_lookup))
  monkeypatch.setattr(segwalk, 'apply_segments',
                      count('segwalk', real_apply))
  runs = {}
  for traced in (False, True):
    if traced:
      obs.enable()
    step, state, batches = _tiny_trainer(0)
    for k in calls:
      calls[k] = 0
    losses = []
    for cats, batch in batches:
      state, loss = step(state, cats, batch)
      losses.append(loss)
    runs[traced] = (losses, state, dict(calls))
  (l0, s0, c0), (l1, s1, c1) = runs[False], runs[True]
  assert c0 == c1 and c0['lookup'] > 0 and c0['segwalk'] > 0
  assert all(torch.equal(a, b) for a, b in zip(l0, l1))
  for k, v in s0.params['embedding'].items():
    assert torch.equal(v, s1.params['embedding'][k]), k
  evs = [e for e in obs_trace.events() if e.get('ph') == 'X']
  names = [e['name'] for e in evs]
  assert names.count('train/step') == 2
  for n in STEP_SPANS | obs_trace.PORT_SPANS:
    assert names.count(n) == 2, n
  for e in evs:
    assert all(isinstance(v, int) for v in e.get('args', {}).values()), e


# every span one sparse hybrid step records, each once
HYBRID_STEP_SPANS = ('fwd/inputs', 'fwd/route', 'fwd/lookup_combine',
                     'fwd/exchange', 'head/forward', 'head/backward',
                     'dense/update', 'bwd/exchange', 'apply/update')


def _dlrm_step(dp_input: bool):
  """A small DLRM's sparse hybrid step as the example builds it, its
  state and one batch (ids in the input path's order)."""
  from distributed_embeddings_tpu_torch.examples.dlrm import main
  model = dlrm.DLRM([30, 20, 50, 10], embedding_dim=8,
                    bottom_mlp_dims=[16, 8], top_mlp_dims=[16, 1],
                    dp_input=dp_input, device='cpu').init(0)
  step, state = main.make_trainer(model, 'sparse', 0.05)
  rng = np.random.default_rng(1)
  cats = [rng.integers(0, n, size=(16,)).astype(np.int32)
          for n in (30, 20, 50, 10)]
  if not dp_input:
    cats = [cats[i] for dev in model.dist_embedding.plan.input_ids_list
            for i in dev]
  numerical = rng.random((16, 13), dtype=np.float32)
  labels = torch.tensor(rng.integers(0, 2, (16, 1)), dtype=torch.float32)
  return step, state, (numerical, cats, labels)


@pytest.mark.parametrize('dp_input', [True, False])
def test_hybrid_step_records_each_phase_once(dp_input):
  """One armed sparse hybrid step, on either input path: one
  ``train/step`` (its ``step`` the state's next), and each phase span
  once inside it on its track, no argument a tensor."""
  step, state, batch = _dlrm_step(dp_input)
  obs_trace.enable()
  step(state, *batch)
  evs = [e for e in obs_trace.events() if e.get('ph') == 'X']
  names = [e['name'] for e in evs]
  assert sorted(names) == sorted(('train/step',) + HYBRID_STEP_SPANS)
  outer = evs[names.index('train/step')]
  assert outer['args'] == {'step': state.step + 1}
  for e in evs:
    assert _inside(e, outer), e
    assert all(isinstance(v, int) for v in e.get('args', {}).values()), e


def test_a_step_that_raises_still_records_its_spans():
  """A hybrid step whose head raises (one numerical feature short) still
  closes and records its ``train/step`` and the phase span it was in,
  as ``fit``'s rollback path catches it."""
  step, state, (numerical, cats, labels) = _dlrm_step(False)
  obs_trace.enable()
  with pytest.raises(RuntimeError):
    step(state, numerical[:, :12], cats, labels)
  evs = [e for e in obs_trace.events() if e.get('ph') == 'X']
  names = [e['name'] for e in evs]
  assert names.count('train/step') == 1 and names.count('head/forward') == 1
  assert 'head/backward' not in names
  outer = evs[names.index('train/step')]
  assert all(_inside(e, outer) for e in evs)


@pytest.mark.parametrize('armed', [True, False])
def test_spans_are_profiler_ranges_while_it_records(tmp_path, armed):
  """Under ``torch.profiler`` (CPU activity) an armed tracer's spans are
  ``user_annotation`` events of the same names, nested as the spans
  are; a disarmed tracer adds none."""
  from torch.profiler import ProfilerActivity, profile
  step, state, batch = _dlrm_step(False)
  step(state, *batch)  # routing plans built outside the profile
  if armed:
    obs_trace.enable()
  with profile(activities=[ProfilerActivity.CPU]) as prof:
    step(state, *batch)
  path = str(tmp_path / 'prof.json')
  prof.export_chrome_trace(path)
  with open(path, encoding='utf-8') as f:
    ann = [e for e in json.load(f)['traceEvents']
           if e.get('cat') == 'user_annotation'
           and e['name'] in obs_trace.REGISTERED_SPANS]
  spans = [e for e in obs_trace.events() if e.get('ph') == 'X']
  if not armed:
    assert ann == [] and spans == []
    return
  assert sorted(e['name'] for e in ann) == sorted(e['name'] for e in spans)
  by_name = {e['name']: e for e in ann}
  outer = by_name['train/step']
  for e in ann:
    assert _inside(e, outer), e
  # the nesting of the span tracer's own events, pair by pair
  own = {e['name']: e for e in spans}
  for a in HYBRID_STEP_SPANS:
    for b in HYBRID_STEP_SPANS:
      if a != b:
        assert _inside(by_name[a], by_name[b]) == _inside(own[a], own[b]), (
            a, b)


def test_traced_training_plus_serving_single_file(tmp_path):
  """A traced 3-step fit plus one batched request: one trace whose phase
  set covers the step and the request path (JAX's required set less the
  CSR feed's, item 15), inside the registered names, accepted by the
  port's report under --strict and by JAX's, which finds only the
  port's own spans unregistered."""
  obs.enable(trace_path=str(tmp_path / 'full_trace.json'))
  cfgs = [TableConfig(48, 8, 'sum'), TableConfig(32, 8, 'sum')]
  rng = np.random.default_rng(0)
  weights = [(rng.normal(size=(c.input_dim, c.output_dim)) * 0.1)
             .astype(np.float32) for c in cfgs]
  dist = DistributedEmbedding(cfgs, dp_input=True, device='cpu')
  kernel = torch.tensor(rng.standard_normal((16, 1)).astype(np.float32))

  def head_loss(dense, emb_outs, labels):
    h = torch.cat(list(emb_outs), dim=-1)
    return torch.mean((h @ dense['kernel'] - labels) ** 2)

  opt = sparse.SparseSGD(learning_rate=0.05)
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  state = sparse.init_hybrid_train_state(
      dist, {'embedding': checkpoint.set_weights(dist, weights),
             'kernel': kernel}, optim.sgd(0.05), opt)
  step = sparse.make_hybrid_train_step(dist, head_loss, optim.sgd(0.05), opt)
  data = [([rng.integers(0, c.input_dim, size=(8,)).astype(np.int32)
            for c in cfgs],
           torch.tensor(rng.normal(size=(8, 1)).astype(np.float32)))
          for _ in range(3)]
  state, history = grad.fit(step, state, iter(data), steps=3, log_every=1,
                            verbose=False)
  assert len(history['loss']) == 3
  engine = serving.ServingEngine(cfgs, weights, batch_size=4, device='cpu')
  with serving.DynamicBatcher(engine, max_delay_ms=2.0) as bat:
    out = bat.submit([x[:2] for x in data[0][0]]).result(timeout=60.0)
  assert out[0].shape == (2, 8)
  path = obs_trace.save()
  rep = trace_report.report(trace_report.load_trace(path))
  required = {'train/step', 'train/sync', 'serve/submit', 'serve/enqueue',
              'serve/dispatch', 'serve/lookup', 'serve/execute',
              'serve/demux'} | STEP_SPANS
  have = set(rep['phases'])
  assert required <= have <= obs_trace.REGISTERED_SPANS, have
  need = ','.join(sorted(required))
  assert trace_report.main([path, '--strict', '--require', need]) == 0
  # the JAX package's report knows its own names: the port's own spans
  # are all it finds unregistered
  jtr = _jax_trace_report()
  assert set(jtr.report(jtr.load_trace(path))['unregistered']) == (
      have & obs_trace.PORT_SPANS)
  assert jtr.main([path, '--require', need]) == 0
