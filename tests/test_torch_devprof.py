"""The port's segmented-dispatch profiler (``obs/devprof.py``) against the
JAX package's (the cases of tests/test_devprof.py): the phase set, the
journal and the metrics on two spawned gloo ranks, the ici / dcn lanes
nested on a 2 x 2 mesh, the refusals, the path with obs off, the
serving rungs and the cost cross-check.  Every trace the port writes
passes the port's ``trace_report --strict``, and the JAX package's
with no name unregistered there but the port's own (``PORT_SPANS``).
"""

import importlib.util
import pathlib
import pickle
import types

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.obs import devprof as jax_devprof
from distributed_embeddings_tpu_torch import obs, serving
from distributed_embeddings_tpu_torch.obs import devprof
from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.ops import segwalk
from distributed_embeddings_tpu_torch.parallel import overlap
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.tools import trace_report
from distributed_embeddings_tpu_torch.utils import resilience

import torch_exchange_worker
import torch_parity

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPECS = [(32, 8, 'sum'), (48, 8, 'sum')]
CFGS = [TableConfig(r, w, combiner=c) for r, w, c in SPECS]


def _jax_trace_report():
  spec = importlib.util.spec_from_file_location(
      'jax_trace_report_for_torch_devprof', ROOT / 'tools' / 'trace_report.py')
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


@pytest.fixture(autouse=True)
def _obs_isolated():
  obs.reset()
  resilience.clear_recent()
  yield
  obs.reset()


def _cats(batch, seed=0, specs=SPECS):
  rng = np.random.default_rng(seed)
  return [rng.integers(0, r, size=(batch,)).astype(np.int32)
          for r, _, _ in specs]


def _spawn(tmp_path, world, shape):
  case = {'tables': SPECS, 'cats': _cats(16), 'batch': 16, 'seed': 3,
          'shape': shape}
  torch_parity.spawn_ranks(torch_exchange_worker.devprof, case, tmp_path,
                           world_size=world, timeout=180)
  outs = []
  for r in range(world):
    with open(tmp_path / f'devprof{r}.pkl', 'rb') as f:
      outs.append(pickle.load(f))
  return outs


def test_profile_step_phases_lane_and_journal_on_two_ranks(tmp_path):
  """Each of two gloo ranks: every STEP_PHASES entry, direct phases
  positive, derived ones floored at 0; the cost model unavailable (JAX's
  note); one devprof_profile journaled with the phases; the metrics;
  the caller's params untouched; on the CPU both clocks are the wall;
  the device lane passes the port's report under --strict --require
  and the JAX package's under --require, the port's own spans all it
  lists as unregistered."""
  jtr = _jax_trace_report()
  for r, out in enumerate(_spawn(tmp_path, 2, None)):
    assert list(out['phases']) == list(devprof.STEP_PHASES)
    assert all(v >= 0.0 for v in out['phases'].values()), out['phases']
    assert out['direct'] == {'dev/fwd/exchange': True,
                             'dev/fwd/lookup_combine': False,
                             'dev/bwd/exchange': True, 'dev/bwd/grad': False,
                             'dev/apply/update': True}
    assert out['phases']['dev/fwd/exchange'] > 0
    assert out['phases']['dev/apply/update'] > 0
    assert out['step_ms'] > 0 and out['coverage_pct'] > 0
    assert out['cost_ok'] is None and 'unavailable' in out['cost_note']
    assert out['dcn_lanes'] is None and out['untouched']
    assert sorted(out['device']) == sorted(
        ['exf', 'exb', 'fwd', 'fwdbwd', 'apply', 'step'])
    assert {d['clock'] for d in out['device'].values()} == {'wall'}
    assert out['device_phases'] == pytest.approx(out['phases'], abs=2e-4)
    assert len(out['journal']) == 1
    assert out['journal'][0]['phases'] == out['phases']
    assert out['journal'][0]['coverage_pct'] == out['coverage_pct']
    assert out['metrics']['devprof.runs'] == 1.0
    assert out['metrics']['devprof.phase_ms']['count'] == 5
    path = str(tmp_path / f'trace{r}.json')
    need = ','.join(devprof.STEP_PHASES)
    assert trace_report.main([path, '--strict', '--require', need]) == 0
    # the JAX package's report knows its own names: the port's own
    # spans (the inputs' copies) are all it finds unregistered
    assert set(jtr.report(jtr.load_trace(path))['unregistered']) <= (
        obs_trace.PORT_SPANS)
    assert jtr.main([path, '--require', need]) == 0
    rep = trace_report.report(trace_report.load_trace(path))
    assert rep['critical_path']['device_ms'] > 0
    assert {n for n, p in rep['phases'].items() if p['cat'] == 'device'} \
        == set(devprof.STEP_PHASES)


def test_profile_step_dcn_lanes_nest_on_a_two_axis_mesh(tmp_path):
  """A dcn_sharding layer on a 2 x 2 gloo mesh: the four DCN_LANES, each
  at least 0, nested inside its parent exchange event on the device
  track; the phase metrics count the lanes too."""
  for r, out in enumerate(_spawn(tmp_path, 4, (2, 2))):
    assert list(out['phases']) == list(devprof.STEP_PHASES)
    assert list(out['dcn_lanes']) == list(devprof.DCN_LANES)
    assert all(v >= 0.0 for v in out['dcn_lanes'].values())
    assert out['dcn_direct']['dev/fwd/exchange/ici'] is True
    assert out['dcn_direct']['dev/bwd/exchange/dcn'] is False
    assert sorted(out['device']) == sorted(
        ['exf', 'exb', 'exf_ici', 'exb_ici', 'fwd', 'fwdbwd', 'apply',
         'step'])
    assert out['journal'][0]['dcn_lanes'] == out['dcn_lanes']
    assert out['metrics']['devprof.phase_ms']['count'] == 9
    path = str(tmp_path / f'trace{r}.json')
    assert trace_report.main([path, '--strict', '--require',
                              ','.join(devprof.DCN_LANES)]) == 0
    ev = {e['name']: e for e in trace_report.load_trace(path)
          if e.get('ph') == 'X'}
    # the lanes are kept to 1e-4 ms, as in JAX: two roundings put their
    # end at most 0.1 us past the parent's
    for lane in devprof.DCN_LANES:
      parent = ev[lane.rsplit('/', 1)[0]]
      assert ev[lane]['tid'] == parent['tid']
      assert parent['ts'] <= ev[lane]['ts']
      assert (ev[lane]['ts'] + ev[lane]['dur']
              <= parent['ts'] + parent['dur'] + 0.11), lane


def test_profile_step_refusal_matrix(monkeypatch):
  """JAX's refusals, before any work: a model-parallel-input layer, a
  hot-cache layer and a cold-tier layer."""
  def no_work(*a, **k):
    raise AssertionError('profile_step worked before refusing')

  monkeypatch.setattr(overlap, 'build_exchange_program', no_work)
  mp_dist = DistributedEmbedding(CFGS, dp_input=False, device='cpu')
  with pytest.raises(ValueError, match='dp_input'):
    devprof.profile_step(mp_dist, _cats(8))
  hot = {0: HotSet(0, np.array([0, 1, 2]))}
  hot_dist = DistributedEmbedding(CFGS, dp_input=True, device='cpu',
                                  hot_cache=hot)
  with pytest.raises(ValueError, match='hot-cache'):
    devprof.profile_step(hot_dist, _cats(8))
  tiered = types.SimpleNamespace(dp_input=True, hot_enabled=False,
                                 cold_tier=object())
  with pytest.raises(ValueError, match='cold-tier'):
    devprof.profile_step(tiered, _cats(8))
  for d in (mp_dist, hot_dist, tiered):
    with pytest.raises(ValueError) as port_err:
      devprof._refuse(d)
    with pytest.raises(ValueError) as jax_err:
      jax_devprof._refuse(d)
    assert ('dp_input' in str(port_err.value)) == (
        'dp_input' in str(jax_err.value))


def test_profile_step_without_obs_still_journals():
  """With obs off: profiled and journaled, no trace event, no metric."""
  dist = DistributedEmbedding(CFGS, dp_input=True, device='cpu')
  prof = devprof.profile_step(dist, _cats(8, seed=1), reps=1)
  assert prof.step_ms > 0 and prof.reps == 1
  assert obs_trace.event_count() == 0
  assert obs_metrics.snapshot() == {}
  assert resilience.recent('devprof_profile')
  assert obs_trace.device_tid() == 0 and obs_trace.event_count() == 0


def test_profile_serving_per_rung(tmp_path, monkeypatch):
  """One positive least-wall a rung, a dev/serve/execute event each with
  the rung in its args, accepted by both reports (the JAX package's
  finds only the port's own spans unregistered); no segment walk."""
  applies = []
  real = segwalk.apply_segments
  monkeypatch.setattr(segwalk, 'apply_segments',
                      lambda *a, **k: applies.append(1) or real(*a, **k))
  rng = np.random.default_rng(0)
  weights = [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
             for r, w, _ in SPECS]
  engine = serving.ServingEngine(CFGS, weights, batch_size=16, device='cpu')
  obs.enable()
  rungs = devprof.profile_serving(engine, reps=2)
  assert set(rungs) == set(engine.buckets)
  assert all(ms > 0 for ms in rungs.values()), rungs
  evs = [e for e in obs_trace.events()
         if e.get('ph') == 'X' and e['name'] == 'dev/serve/execute']
  assert sorted(e['args']['rung'] for e in evs) == sorted(engine.buckets)
  assert len({e['tid'] for e in evs}) == 1
  assert not applies
  assert resilience.recent('devprof_profile')[-1]['serve_rung_ms'] == {
      str(k): v for k, v in rungs.items()}
  path = str(tmp_path / 'serve_dev.json')
  obs_trace.save(path)
  assert trace_report.main([path, '--strict',
                            '--require', 'dev/serve/execute']) == 0
  # the JAX package's report: every name its own but the ids' copies
  # to the device, the port's own span
  jtr = _jax_trace_report()
  assert jtr.report(jtr.load_trace(path))['unregistered'] == [
      'fwd/inputs', 'fwd/route']
  assert jtr.main([path]) == 0


@pytest.mark.parametrize('case', [
    {'fwd': {'flops': 10.0, 'bytes': 100.0},
     'fwdbwd': {'flops': 3.0, 'bytes': 105.0},
     'step': {'flops': 40.0, 'bytes': 400.0}},
    {'fwd': {'flops': 10.0, 'bytes': 500.0},
     'fwdbwd': {'flops': 30.0, 'bytes': 300.0},
     'step': {'flops': 40.0, 'bytes': 400.0}},
    {'fwd': None, 'fwdbwd': {'flops': 1.0, 'bytes': 1.0},
     'step': {'flops': 1.0, 'bytes': 1.0}},
    {'fwd': None, 'fwdbwd': None, 'step': None}])
def test_cost_cross_check_matches_jax(case):
  assert devprof._cost_cross_check(case) == jax_devprof._cost_cross_check(
      case)


def test_device_clock_on_the_cpu_is_the_wall():
  calls = []
  assert devprof.device_clock_ms(lambda: calls.append(1), 3,
                                 torch.device('cpu'), 1.5) == (1.5, 'wall')
  assert not calls  # the CPU clock runs nothing more
