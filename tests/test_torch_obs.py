"""The port's copies of ``obs/trace.py`` and ``obs/metrics.py`` and its
journal names (cases of tests/test_obs.py), and the spans and counters
that the checkpoint files, the auditor and ``fit`` emit."""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.obs import metrics as jax_metrics
from distributed_embeddings_tpu.utils import resilience as jax_resilience
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.parallel import audit
from distributed_embeddings_tpu_torch.parallel import callbacks
from distributed_embeddings_tpu_torch.parallel import grad
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.utils import resilience

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / 'distributed_embeddings_tpu_torch'


def _reset():
  obs_trace.disable()
  obs_trace.clear()
  obs_metrics.disable()
  obs_metrics.reset()


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
  spans = [v for _, n, v in _literals({'span', 'complete'})]
  metrics = [v for _, n, v in _literals({'inc', 'observe', 'set_gauge'})]
  events = [v for _, n, v in _literals({'journal'}, owner='resilience')]
  assert {'train/step', 'train/sync', 'ckpt/save', 'ckpt/restore',
          'audit/check'} <= set(spans) <= obs_trace.REGISTERED_SPANS
  assert set(metrics) <= obs_metrics.REGISTERED_METRICS and metrics
  assert set(events) <= resilience.REGISTERED_EVENTS
  assert {'rollback', 'checkpoint_quarantined', 'audit_failure'} <= set(
      events)
  assert resilience.REGISTERED_EVENTS <= jax_resilience.REGISTERED_EVENTS
  assert all(jax_metrics.METRIC_TYPES[k] == t
             for k, t in obs_metrics.METRIC_TYPES.items())


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
  names = [e['name'] for e in obs_trace.events() if e['ph'] == 'X']
  assert names.count('train/step') == 4 and names.count('train/sync') == 2
  assert names.count('ckpt/save') == 2 and names.count('audit/check') == 4
  snap = obs_metrics.snapshot()
  assert snap['train.steps'] == 4 and snap['ckpt.saves'] == 2
  assert snap['audit.calls'] == 4 and snap['ckpt.save_ms']['count'] == 2
  assert resilience.recent('metrics_snapshot')
