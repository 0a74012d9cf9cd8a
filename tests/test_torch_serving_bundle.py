"""Serving bundles and ``ServingEngine.from_bundle`` in the port against
the JAX package (the contracts of tests/test_serving.py's export,
restore and engine tests): a bundle written by either package loads in
the other with equal weights, meta and manifest; the refusals are
JAX's; a quantized restore never widens; an engine started from a
JAX-written bundle answers as JAX's engine and JAX's training forward
(bit-exact at hotness 1, 1e-6 multi-hot); ``hot_only_filter`` and the
stats keys equal JAX's; the export CLI and the DLRM serving example."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax

from distributed_embeddings_tpu import serving as jax_serving
from distributed_embeddings_tpu.parallel import (DistributedEmbedding as
                                                 JaxDistributedEmbedding)
from distributed_embeddings_tpu.parallel import TableConfig as JaxTableConfig
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import create_mesh
from distributed_embeddings_tpu.parallel.hotcache import HotSet as JaxHotSet
from distributed_embeddings_tpu.utils import faultinject
from distributed_embeddings_tpu_torch import serving
from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
from distributed_embeddings_tpu_torch.examples.dlrm import serve as dlrm_serve
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.tools import export_serving
from distributed_embeddings_tpu_torch.tools import trace_report

torch.set_num_threads(1)

SPECS = [(48, 8, 'sum'), (32, 8, 'sum'), (40, 4, None)]
CONFIGS = [TableConfig(*s) for s in SPECS]
JAX_CONFIGS = [JaxTableConfig(*s) for s in SPECS]
HOT_TRAIN = {0: [0, 1, 2, 5], 1: [0, 1, 2, 3]}
HOT_SERVE = {0: [3, 7, 9], 1: [0, 8, 20, 31]}
HOTNESS = (1, 3, 1)
BATCH = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _hot(sets, cls):
  return {t: cls(t, np.array(ids)) for t, ids in sets.items()}


def _ids(rng, n=BATCH):
  out = [rng.integers(0, SPECS[0][0], size=(n,)).astype(np.int32)]
  multi = rng.integers(0, SPECS[1][0], size=(n, 3)).astype(np.int32)
  if n > 2:
    multi[1, 2] = -1                  # padding inside a bag
    multi[2, 0] = SPECS[1][0] + 7     # out of vocabulary
  out.append(multi)
  out.append(rng.integers(0, SPECS[2][0], size=(n,)).astype(np.int32))
  return out


def _assert_answers(got, want):
  for i, (g, w) in enumerate(zip(got, want)):
    g = np.asarray(g.detach().cpu() if isinstance(g, torch.Tensor) else g)
    if HOTNESS[i] == 1:
      np.testing.assert_array_equal(g, np.asarray(w), err_msg=f'input {i}')
    else:
      np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-6,
                                 err_msg=f'input {i}')


@pytest.fixture(scope='module')
def served(tmp_path_factory):
  """JAX's served fixture: an int8 source trained on an 8-device mesh,
  its checkpoint (with Adagrad slots), the bundle JAX exports and the
  one the port exports from it, JAX's 2-device engine under another hot
  set, the port's world-1 engine from the JAX bundle, and the training
  forward's outputs."""
  td = str(tmp_path_factory.mktemp('bundles'))
  rng = np.random.default_rng(0)
  weights = [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
             for r, w, _ in SPECS]
  train = JaxDistributedEmbedding(
      JAX_CONFIGS, mesh=create_mesh(jax.devices()[:8]), dp_input=True,
      hot_cache=_hot(HOT_TRAIN, JaxHotSet), table_dtype='int8')
  params = jax_ckpt.set_weights(train, weights)
  ckpt = os.path.join(td, 'ckpt_7.npz')
  jax_ckpt.save_train_npz(ckpt, jax_ckpt.export_tables(train, params),
                          [{'acc': np.abs(w) + 0.1} for w in weights],
                          extras={'step': np.int64(7)}, plan=train)
  jax_bundle = os.path.join(td, 'jax_bundle.npz')
  port_bundle = os.path.join(td, 'port_bundle.npz')
  jax_summary = jax_serving.export_bundle_from_checkpoint(
      ckpt, jax_bundle, table_configs=JAX_CONFIGS)
  port_summary = serving.export_bundle_from_checkpoint(
      ckpt, port_bundle, table_configs=CONFIGS)
  jax_engine = jax_serving.ServingEngine.from_bundle(
      jax_bundle, mesh=create_mesh(jax.devices()[:2]), batch_size=BATCH,
      hot_sets=_hot(HOT_SERVE, JaxHotSet), hotness=HOTNESS)
  engine = serving.ServingEngine.from_bundle(
      jax_bundle, batch_size=BATCH, hot_sets=_hot(HOT_SERVE, HotSet),
      hotness=HOTNESS, device='cpu')
  ids = _ids(np.random.default_rng(1))
  ref = [np.asarray(x) for x in train.apply(params, ids)]
  return dict(td=td, weights=weights, train=train, params=params,
              ckpt=ckpt, jax_bundle=jax_bundle, port_bundle=port_bundle,
              jax_summary=jax_summary, port_summary=port_summary,
              jax_engine=jax_engine, engine=engine, ids=ids, ref=ref)


# ---------------------------------------------------------------- files


def test_summary_equals_jax(served):
  a, b = dict(served['port_summary']), dict(served['jax_summary'])
  assert a.pop('path') == served['port_bundle']
  assert b.pop('path') == served['jax_bundle']
  assert a == b
  assert a['stripped_state_leaves'] == len(SPECS)
  assert a['quantized'] == ['int8'] and a['step'] == 7


def test_bundles_have_the_same_members_and_manifest(served):
  """The two packages' bundles of one checkpoint: the same members, the
  same sha256 for every array and the same plan fingerprint; int8
  payload and f32 scale only, no optimizer member."""
  man_p = checkpoint.read_manifest(served['port_bundle'])
  man_j = jax_ckpt.read_manifest(served['jax_bundle'])
  assert man_p == man_j
  assert man_p['plan'] == jax_ckpt.plan_fingerprint(served['train'])
  with np.load(served['port_bundle']) as zf:
    assert zf['table0'].dtype == np.int8
    assert zf['table0:scale'].dtype == np.float32
    assert not any(k.startswith('table') and '/' in k for k in zf.files)


@pytest.mark.parametrize('writer', ['port', 'jax'])
@pytest.mark.parametrize('reader', ['port', 'jax'])
def test_bundles_load_both_ways(served, writer, reader):
  path = served[f'{writer}_bundle']
  load = (serving.load_serving_bundle if reader == 'port'
          else jax_serving.load_serving_bundle)
  weights, meta = load(path)
  ref_w, ref_meta = jax_serving.load_serving_bundle(served['jax_bundle'])
  assert {k: v for k, v in meta.items() if k != 'table_configs'} == {
      k: v for k, v in ref_meta.items() if k != 'table_configs'}
  assert [(c.input_dim, c.output_dim, c.combiner)
          for c in meta['table_configs']] == list(SPECS)
  assert meta['step'] == 7 and meta['format'] == serving.SERVING_FORMAT
  for a, b in zip(weights, ref_w):
    assert a.dtype_name == b.dtype_name == 'int8'
    np.testing.assert_array_equal(np.asarray(a.payload),
                                  np.asarray(b.payload))
    np.testing.assert_array_equal(np.asarray(a.scale), np.asarray(b.scale))


def test_live_export_matches_checkpoint_export(served, tmp_path):
  """A live port layer holding the bundle's tables exports the same
  payload and scale bits, with configs and no slots."""
  live = str(tmp_path / 'live.npz')
  eng = served['engine']
  serving.export_serving_bundle(eng.dist, eng.params, live, step=7)
  a, ma = serving.load_serving_bundle(live)
  b, _ = jax_serving.load_serving_bundle(served['jax_bundle'])
  assert ma['table_configs'] is not None and ma['source'] == 'live'
  for x, y in zip(a, b):
    np.testing.assert_array_equal(x.payload, np.asarray(y.payload))
    np.testing.assert_array_equal(x.scale, np.asarray(y.scale))


def test_raw_train_checkpoint_refuses(served):
  with pytest.raises(ValueError, match='serving_format'):
    serving.load_serving_bundle(served['ckpt'])


def test_corrupt_bundle_refuses(served, tmp_path):
  bad = str(tmp_path / 'bad.npz')
  shutil.copy(served['port_bundle'], bad)
  faultinject.flip_bytes(bad, count=8, seed=3)
  with pytest.raises(ValueError, match='invalid serving bundle'):
    serving.load_serving_bundle(bad)


def test_manifest_less_file_refuses(served, tmp_path):
  plain = str(tmp_path / 'plain.npz')
  checkpoint.save_npz(plain, served['weights'])
  with pytest.raises(ValueError, match='manifest'):
    serving.load_serving_bundle(plain)


def test_bundle_with_optimizer_slots_refuses(served, tmp_path):
  slotted = str(tmp_path / 'slotted.npz')
  checkpoint.save_train_npz(
      slotted, served['weights'],
      [{'acc': np.ones(w.shape, np.float32)} for w in served['weights']],
      extras={'serving_format': np.int64(1)})
  for load in (serving.load_serving_bundle, jax_serving.load_serving_bundle):
    with pytest.raises(ValueError, match='optimizer-state members'):
      load(slotted)


def test_quantized_restore_never_widens(served, monkeypatch):
  """An int8 bundle written under 8 devices restores into the port's
  world-1 int8 plan under another hot set without its f32 values ever
  being made, and re-exports the same payload and scale bits."""
  weights, _ = serving.load_serving_bundle(served['jax_bundle'])

  def boom(*args, **kwargs):
    raise AssertionError('the restore widened a same-dtype '
                         'QuantizedWeight to f32')

  monkeypatch.setattr(checkpoint.QuantizedWeight, 'values', boom)
  monkeypatch.setattr(checkpoint.QuantizedWeight, 'rows', boom)
  eng = serving.ServingEngine(CONFIGS, weights, batch_size=BATCH,
                              hot_sets={2: HotSet(2, np.array([1, 2]))},
                              device='cpu')
  monkeypatch.undo()
  assert eng.stats()['table_dtype'] == 'int8'
  for a, b in zip(weights, checkpoint.export_tables(eng.dist, eng.params)):
    np.testing.assert_array_equal(a.payload, b.payload)
    np.testing.assert_array_equal(a.scale, b.scale)


# --------------------------------------------------------------- engine


def test_from_bundle_answers_as_jax(served):
  """The port's engine from the JAX bundle (world of one, the serving
  hot set) against JAX's 2-device engine on the same bundle and JAX's
  8-device training forward."""
  eng = served['engine']
  assert eng.bundle_meta['step'] == 7
  assert eng.stats()['table_dtype'] == 'int8'
  got = eng.lookup_padded(served['ids'])
  _assert_answers(got, served['ref'])
  _assert_answers(got, served['jax_engine'].lookup_padded(served['ids']))
  for n in (1, 3, 9):
    req = [c[:n] for c in served['ids']]
    _assert_answers(eng.lookup_padded(req),
                    served['jax_engine'].lookup_padded(req))


def test_from_port_bundle_in_jax(served):
  jeng = jax_serving.ServingEngine.from_bundle(
      served['port_bundle'], mesh=create_mesh(jax.devices()[:1]),
      batch_size=BATCH, hotness=HOTNESS)
  _assert_answers(served['engine'].lookup_padded(served['ids']),
                  jeng.lookup_padded(served['ids']))


def test_from_bundle_without_configs(served, tmp_path):
  bare = str(tmp_path / 'bare.npz')
  serving.export_bundle_from_checkpoint(served['ckpt'], bare)
  assert serving.load_serving_bundle(bare)[1]['table_configs'] is None
  with pytest.raises(ValueError, match='no embedded table configs'):
    serving.ServingEngine.from_bundle(bare, batch_size=BATCH, device='cpu')
  eng = serving.ServingEngine.from_bundle(
      bare, table_configs=CONFIGS, batch_size=BATCH, hotness=HOTNESS,
      device='cpu')
  _assert_answers(eng.lookup_padded(served['ids']), served['ref'])


def test_hot_only_filter_equals_jax(served):
  rng = np.random.default_rng(4)
  for n in (1, 5, BATCH):
    cats = _ids(rng, n)
    got, dropped, total = served['engine'].hot_only_filter(cats)
    want, jd, jt = served['jax_engine'].hot_only_filter(cats)
    assert (dropped, total) == (jd, jt) and total > 0
    for g, w in zip(got, want):
      assert g.dtype == w.dtype
      np.testing.assert_array_equal(g, w)
  assert served['engine'].hot_filter_available
  plain = serving.ServingEngine(CONFIGS, served['weights'],
                                batch_size=BATCH, device='cpu')
  assert not plain.hot_filter_available
  cats = _ids(rng)
  out, dropped, total = plain.hot_only_filter(cats)
  assert dropped == 0 and total == sum(int((c >= 0).sum()) for c in cats)


@pytest.mark.parametrize('table_dtype', [None, 'int8'])
def test_stats_keys_equal_jax(served, table_dtype):
  """The engine's stats: the JAX engine's keys, the same values for the
  same configuration at a world of one (the repaired 'table_dtype'
  included)."""
  kw = dict(batch_size=BATCH, hotness=HOTNESS, table_dtype=table_dtype)
  eng = serving.ServingEngine(CONFIGS, served['weights'], device='cpu',
                              hot_sets=_hot(HOT_SERVE, HotSet), **kw)
  jeng = jax_serving.ServingEngine(
      JAX_CONFIGS, served['weights'], mesh=create_mesh(jax.devices()[:1]),
      hot_sets=_hot(HOT_SERVE, JaxHotSet), **kw)
  for e in (eng, jeng):
    e.lookup_padded([c[:3] for c in served['ids']])
  assert eng.stats() == jeng.stats()
  assert eng.stats()['table_dtype'] == table_dtype


# ------------------------------------------------------------------ CLI


def _jax_cli():
  sys.path.insert(0, os.path.join(REPO, 'tools'))
  try:
    import export_serving as jax_export_serving
  finally:
    sys.path.pop(0)
  return jax_export_serving


@pytest.mark.parametrize('flags', [
    ['--tables', '48,8,sum;32,8,sum;40,4,none'],
    ['--combiner', 'sum', '--json'],
])
def test_export_cli_equals_jax(served, tmp_path, capsys, flags):
  """The port's CLI and JAX's on the same checkpoint: exit 0, the same
  output (paths aside) and bundles with the same manifest."""
  outs = {}
  for name, cli in (('port', export_serving), ('jax', _jax_cli())):
    path = str(tmp_path / f'{name}.npz')
    assert cli.main([served['ckpt'], '--out', path, *flags]) == 0
    outs[name] = (capsys.readouterr().out.replace(path, 'OUT'),
                  checkpoint.read_manifest(path))
  assert outs['port'] == outs['jax']
  assert 'optimizer slot(s) stripped' in outs['port'][0] or flags[-1] == \
      '--json'
  weights, meta = serving.load_serving_bundle(str(tmp_path / 'port.npz'))
  want = 'sum' if '--combiner' in flags else None
  assert meta['table_configs'][2].combiner == want
  if '--json' in flags:
    assert json.loads(outs['port'][0])['tables'] == len(SPECS)


def test_export_cli_failure_exits_one(tmp_path, capsys):
  path = str(tmp_path / 'missing.npz')
  assert export_serving.main([path, '--out', str(tmp_path / 'b.npz')]) == 1
  assert 'export_serving: FINDINGS: export failed' in capsys.readouterr().err


# -------------------------------------------------------------- example


def test_serve_example_on_a_main_checkpoint(tmp_path, capsys):
  """The DLRM serving example on the CPU at a small size, from a
  checkpoint the port's main.py wrote: the bundle, the engine, the
  three arms and the overload arm, the JAX example's keys."""
  ckpt = str(tmp_path / 'ckpt.npz')
  dlrm_main.main(['--device', 'cpu', '--batch_size', '64', '--table_sizes',
                  '3000,2000,5000,1100', '--embedding_dim', '8',
                  '--bottom_mlp_dims', '16,8', '--top_mlp_dims', '16,1',
                  '--num_batches', '3', '--max_steps', '2',
                  '--save_state', ckpt])
  capsys.readouterr()
  bundle = str(tmp_path / 'bundle.npz')
  stats = dlrm_serve.main(['--device', 'cpu', '--checkpoint', ckpt,
                           '--bundle', bundle, '--batch', '32',
                           '--requests', '48', '--hot_coverage', '0.9',
                           '--overload_qps', '0', '--replicas', '2',
                           '--deadline_ms', '5000'])
  out = capsys.readouterr().out
  assert 'bundle: 4 table(s) from ckpt.npz step 2' in out
  assert 'A/B  ladder+pipe' in out and 'A/B  degraded' in out
  assert json.loads(out.strip().splitlines()[-1]) == stats
  assert stats['serve_requests'] == stats['serve_over_requests'] == 48
  assert stats['serve_over_served'] + stats['serve_over_shed'] == 48
  assert stats['serve_over_quarantined'] == 1
  assert 0.0 <= stats['serve_hot_hit_rate'] <= 1.0
  eng = serving.ServingEngine.from_bundle(bundle, batch_size=32,
                                          device='cpu')
  assert [c.combiner for c in eng.dist.table_configs] == [None] * 4
  # --trace (item 14): the request path's spans, accepted by the report
  trace = str(tmp_path / 'serve_trace.json')
  dlrm_serve.main(['--device', 'cpu', '--checkpoint', ckpt, '--batch', '32',
                   '--requests', '16', '--hot_coverage', '0',
                   '--overload_qps', '0', '--trace', trace])
  assert trace_report.main([trace, '--strict', '--require',
                            'serve/submit,serve/enqueue,serve/dispatch,'
                            'serve/lookup,serve/execute,serve/demux,'
                            'fwd/lookup_combine']) == 0
