"""The port's copy of the planner places every row exactly as the JAX
package's planner does: same groups, requests, offsets, shard layout and
fingerprint, for the synthetic models at full size."""

import dataclasses

import numpy as np
import pytest
import torch

from distributed_embeddings_tpu.models import synthetic as jax_synthetic
from distributed_embeddings_tpu.parallel import hotcache as jax_hotcache
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import quantization as jax_quant
from distributed_embeddings_tpu_torch.models import synthetic
from distributed_embeddings_tpu_torch.parallel import _plan_deps
from distributed_embeddings_tpu_torch.parallel import planner

torch.set_num_threads(1)


def _plain(x):
  """Dataclasses, tuples and arrays as nested lists/dicts for ==."""
  if dataclasses.is_dataclass(x):
    return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
  if isinstance(x, (list, tuple)):
    return [_plain(v) for v in x]
  if isinstance(x, dict):
    return {k: _plain(v) for k, v in x.items()}
  if isinstance(x, np.ndarray):
    return x.tolist()
  return x


def _assert_same_plan(port_plan, jax_plan):
  assert _plain(port_plan.groups) == _plain(jax_plan.groups)
  assert _plain(port_plan.input_requests) == _plain(jax_plan.input_requests)
  assert port_plan.input_table_map == jax_plan.input_table_map
  assert port_plan.shard_layout() == jax_plan.shard_layout()
  assert port_plan.table_ids == jax_plan.table_ids
  assert port_plan.fingerprint() == jax_plan.fingerprint()


def _tables(module, name):
  tables, itm, _ = module.expand_tables(module.SYNTHETIC_MODELS[name])
  return tables, itm


@pytest.mark.parametrize('packed', [True, False])
@pytest.mark.parametrize('strategy',
                         ['basic', 'memory_balanced', 'memory_optimized'])
@pytest.mark.parametrize('world_size', [1, 2, 8])
@pytest.mark.parametrize('model', ['tiny', 'small'])
def test_plan_matches_jax(model, world_size, strategy, packed):
  jt, itm = _tables(jax_synthetic, model)
  pt, pitm = _tables(synthetic, model)
  assert itm == pitm
  want = jax_planner.ShardingPlan(jt, world_size, strategy=strategy,
                                  input_table_map=itm,
                                  packed_storage=packed)
  got = planner.ShardingPlan(pt, world_size, strategy=strategy,
                             input_table_map=pitm, packed_storage=packed)
  _assert_same_plan(got, want)


@pytest.mark.parametrize('kw', [
    dict(column_slice_threshold=10**6),
    dict(row_slice_threshold=2 * 10**8),
    dict(row_slice_threshold=2 * 10**8, mod_sharding=True),
    dict(device_hbm_budget=2 * 10**9),
])
def test_sliced_plan_matches_jax(kw):
  jt, itm = _tables(jax_synthetic, 'tiny')
  pt, _ = _tables(synthetic, 'tiny')
  want = jax_planner.ShardingPlan(jt, 4, strategy='memory_balanced',
                                  input_table_map=itm, **kw)
  got = planner.ShardingPlan(pt, 4, strategy='memory_balanced',
                             input_table_map=itm, **kw)
  _assert_same_plan(got, want)


def test_hot_and_quantized_plan_matches_jax():
  # the planner copy carries the plan features the runtime does not
  # serve yet, so a later slice inherits identical placement
  jt, itm = _tables(jax_synthetic, 'tiny')
  pt, _ = _tables(synthetic, 'tiny')
  ids = np.arange(0, 4000, 3)
  want = jax_planner.ShardingPlan(
      jt, 2, input_table_map=itm, table_dtype='int8',
      hot_sets={1: jax_hotcache.HotSet(1, ids, 0.5)})
  got = planner.ShardingPlan(
      pt, 2, input_table_map=itm, table_dtype='int8',
      hot_sets={1: _plan_deps.HotSet(1, ids, 0.5)})
  _assert_same_plan(got, want)


def test_plan_deps_match_jax():
  ids = np.array([2, 5, 9])
  assert (_plan_deps.HotSet(3, ids).fingerprint_material()
          == jax_hotcache.HotSet(3, ids).fingerprint_material())
  with pytest.raises(ValueError):
    _plan_deps.HotSet(0, np.array([3, 1]))
  assert _plan_deps.SCALE_BYTES == jax_quant.SCALE_BYTES
  for name in ('int8', 'float8_e4m3'):
    a = _plan_deps.resolve_table_dtype(name)
    b = jax_quant.resolve_table_dtype(name)
    # the port stores fp8 as torch.float8_e4m3fn on the device and as its
    # uint8 bits on the host (no ml_dtypes), so the JAX spec's numpy
    # dtype compares by width
    assert (a.name, a.qmax, a.integer, a.itemsize) == (
        b.name, b.qmax, b.integer, np.dtype(b.dtype).itemsize)
    assert a.torch_dtype == {'int8': torch.int8,
                             'float8_e4m3': torch.float8_e4m3fn}[name]
    for w in (8, 16, 128):
      assert (_plan_deps.wire_bytes_per_row(w, a)
              == jax_quant.wire_bytes_per_row(w, b))
  assert _plan_deps.resolve_table_dtype(None) is None
  with pytest.raises(ValueError):
    _plan_deps.resolve_table_dtype('int4')


def test_fuse_layout_matches_jax():
  entries = [('g0', (2, 3, 8, 1), 'int32'), ('g1', (2, 1, 8, 10), 'int32'),
             ('g2', (2, 4, 8, 16), 'float32')]
  want = jax_planner.fuse_layout('fwd/ids', entries)
  got = planner.fuse_layout('fwd/ids', entries)
  assert [l.as_dict() for l in got] == [l.as_dict() for l in want]
