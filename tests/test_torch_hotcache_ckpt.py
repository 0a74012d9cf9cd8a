"""Hot membership is a layout detail (docs/design.md §10), across the two
packages: checkpoint files written under one hot set restore bit for bit
under another hot set and under none, whichever package wrote them and
whichever reads them (tests/test_hotcache.py:263-364, both directions),
including ``restore_train_state`` in place; and the serving engine with
hot sets answers as the engine without them and as JAX's.  CPU, world of
one (the JAX side on a one-device mesh with natural storage).
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.models import synthetic as jax_synthetic
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import hotcache as jax_hotcache
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu.serving import engine as jax_engine
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.models import synthetic
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import hotcache
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.serving import engine

import torch_parity

torch.set_num_threads(1)

# tests/test_hotcache.py's checkpoint fixtures
SPECS = [(100, 8, 'sum'), (64, 8, 'sum'), (50, 8, None)]
SET_A = {0: [0, 1, 2, 3, 7, 11], 1: list(range(10))}
SET_B = {0: [40, 41, 42], 2: [5, 9]}
ADAM_SPECS = SPECS[:2]
ADAM_SET_A = {0: [0, 1, 2, 3, 7, 11]}
ADAM_SET_B = {0: [40, 41, 42], 1: [5, 9]}
PACKAGES = ('port', 'jax')


def _hot(ids, package):
  if ids is None:
    return None
  cls = hotcache.HotSet if package == 'port' else jax_hotcache.HotSet
  return {t: cls(t, np.asarray(v)) for t, v in ids.items()}


def _layer(package, specs, ids):
  if package == 'port':
    return DistributedEmbedding([TableConfig(*s) for s in specs],
                                device='cpu', dp_input=True,
                                hot_cache=_hot(ids, package))
  return JaxDistributedEmbedding(
      [jax_planner.TableConfig(*s) for s in specs],
      mesh=torch_parity.jax_mesh(1), dp_input=True, packed_storage=False,
      hot_cache=_hot(ids, package))


def _pkg(package):
  return (checkpoint, sparse) if package == 'port' else (jax_ckpt,
                                                         jax_sparse)


def _np(a):
  return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _train(package, specs, ids, make_opt, weights, kernel, labels, cats,
           steps=3):
  """``steps`` hybrid steps under hot set ``ids``: ``(layer, state)``."""
  dist = _layer(package, specs, ids)
  ckpt, sp = _pkg(package)
  opt = make_opt(sp)
  if package == 'port':
    def head_loss(dense_params, emb_outs, labels):
      h = torch.cat(list(emb_outs), dim=-1)
      return torch.mean((h @ dense_params['kernel'] - labels)**2)

    dense_opt = optim.sgd(0.05)
    kernel, labels = torch.tensor(kernel), torch.tensor(labels)
    step = sp.make_hybrid_train_step(dist, head_loss, dense_opt, opt)
  else:
    def head_loss(dense_params, emb_outs, labels):
      h = jnp.concatenate(list(emb_outs), axis=-1)
      return jnp.mean((h @ dense_params['kernel'] - labels)**2)

    dense_opt = optax.sgd(0.05)
    kernel, labels = jnp.asarray(kernel), jnp.asarray(labels)
    cats = [jnp.asarray(c) for c in cats]
    step = sp.make_hybrid_train_step(dist, head_loss, dense_opt, opt,
                                     donate=False)
  state = sp.init_hybrid_train_state(
      dist, {'embedding': ckpt.set_weights(dist, weights), 'kernel': kernel},
      dense_opt, opt)
  for _ in range(steps):
    state, _ = step(state, cats, labels)
  return dist, state


def _case(specs, seed, batch=8):
  rng = np.random.default_rng(seed)
  weights = [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
             for r, w, _ in specs]
  kernel = (rng.standard_normal((sum(w for _, w, _ in specs), 1))
            * 0.1).astype(np.float32)
  labels = rng.integers(0, 2, (batch, 1)).astype(np.float32)
  cats = [rng.integers(0, r, size=(batch,)).astype(np.int32)
          for r, _, _ in specs]
  return weights, kernel, labels, cats


def _apply(package, dist, params, cats):
  if package == 'port':
    return [o.numpy() for o in dist.apply(params, cats)]
  return [np.asarray(o) for o in dist.apply(params,
                                            [jnp.asarray(c) for c in cats])]


@pytest.mark.parametrize('reader', PACKAGES)
@pytest.mark.parametrize('writer', PACKAGES)
def test_checkpoint_across_hot_sets_bit_exact(writer, reader, tmp_path):
  """Train under hot set A (``writer``), save the canonical file, restore
  it (``reader``) under no cache and under a DIFFERENT hot set B:
  forwards bit-equal to the trained layer's, the accumulators
  round-trip, and the file holds no hot leaf."""
  weights, kernel, labels, cats = _case(SPECS, 2)
  make_opt = lambda sp: sp.SparseAdagrad(learning_rate=0.05)
  dA, state = _train(writer, SPECS, SET_A, make_opt, weights, kernel,
                     labels, cats)
  ckpt, _ = _pkg(writer)
  wA = ckpt.get_weights(dA, state.params['embedding'])
  sA = ckpt.get_optimizer_state(dA, state.opt_state[1])
  path = str(tmp_path / 'ck.npz')
  ckpt.save_train_npz(path, wA, sA, plan=dA)
  with np.load(path) as data:
    assert not any('hot' in k for k in data.files), data.files
  oA = _apply(writer, dA, state.params['embedding'], cats)
  rckpt, rsp = _pkg(reader)
  wl, sl, _ = rckpt.load_train_npz(path)
  for ids in (None, SET_B):
    d2 = _layer(reader, SPECS, ids)
    p2 = rckpt.set_weights(d2, wl)
    for a, b in zip(_apply(reader, d2, p2, cats), oA):
      np.testing.assert_array_equal(a, b)
    s2 = rckpt.set_optimizer_state(
        d2, rsp.SparseAdagrad(learning_rate=0.05).init(d2, p2), sl)
    for t, entry in enumerate(rckpt.get_optimizer_state(d2, s2)):
      np.testing.assert_array_equal(_np(sA[t]['acc']), _np(entry['acc']))
    for a, b in zip(rckpt.get_weights(d2, p2), wA):
      np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize('reader', PACKAGES)
@pytest.mark.parametrize('writer', PACKAGES)
def test_adam_hot_checkpoint_roundtrip(writer, reader):
  """SparseAdam's split hot state (the per-row step count ``t``, a 1-D
  hot leaf, and the moments) canonicalises into the per-table layout and
  restores bit for bit under another hot set and under none."""
  weights, kernel, labels, cats = _case(ADAM_SPECS, 4)
  make_opt = lambda sp: sp.SparseAdam(learning_rate=0.01)
  dA, state = _train(writer, ADAM_SPECS, ADAM_SET_A, make_opt, weights,
                     kernel, labels, cats)
  ckpt, _ = _pkg(writer)
  sA = ckpt.get_optimizer_state(dA, state.opt_state[1])
  wA = ckpt.get_weights(dA, state.params['embedding'])
  # some hot row was touched: its canonical 't' advanced
  assert any(np.any(_np(s['t']) > 0) for s in sA)
  rckpt, rsp = _pkg(reader)
  for ids in (None, ADAM_SET_B):
    d2 = _layer(reader, ADAM_SPECS, ids)
    p2 = rckpt.set_weights(d2, [_np(w) for w in wA])
    s2 = rckpt.set_optimizer_state(
        d2, rsp.SparseAdam(learning_rate=0.01).init(d2, p2),
        [{k: _np(v) if k != 't' else np.asarray(v) for k, v in s.items()}
         for s in sA])
    for t, entry in enumerate(rckpt.get_optimizer_state(d2, s2)):
      for k in ('m', 'v', 't'):
        np.testing.assert_array_equal(
            np.asarray(sA[t][k]), np.asarray(entry[k]),
            err_msg=f'{writer}->{reader} {ids} table {t} leaf {k}')


def test_restore_train_state_in_place_across_hot_sets(tmp_path):
  """``restore_train_state`` of a file written under hot set A writes the
  hot buffers and their split state of a state under hot set B in place:
  its canonical tables and accumulators equal the file's."""
  weights, kernel, labels, cats = _case(SPECS, 6)
  make_opt = lambda sp: sp.SparseAdagrad(learning_rate=0.05)
  dA, state = _train('port', SPECS, SET_A, make_opt, weights, kernel,
                     labels, cats)
  path = str(tmp_path / 'ckpt_3.npz')
  checkpoint.save_train_npz(
      path, checkpoint.get_weights(dA, state.params['embedding']),
      checkpoint.get_optimizer_state(dA, state.opt_state[1]),
      extras=checkpoint.train_extras(dA, state), plan=dA)
  dB, fresh = _train('port', SPECS, SET_B, make_opt, weights, kernel,
                     labels, cats, steps=0)
  hot_before = fresh.params['embedding']['hot_group_0']
  got, src = checkpoint.restore_train_state(dB, fresh, path)
  assert src == path and got.step == 3
  assert got.params['embedding']['hot_group_0'] is hot_before
  for a, b in zip(checkpoint.get_weights(dB, got.params['embedding']),
                  checkpoint.get_weights(dA, state.params['embedding'])):
    assert torch.equal(a, b)
  for a, b in zip(checkpoint.get_optimizer_state(dB, got.opt_state[1]),
                  checkpoint.get_optimizer_state(dA, state.opt_state[1])):
    assert torch.equal(a['acc'], b['acc'])
  for a, b in zip(dB.apply(got.params['embedding'], cats),
                  dA.apply(state.params['embedding'], cats)):
    assert torch.equal(a, b)


BATCH = 64


@pytest.fixture(scope='module')
def engines():
  """Three engines over the reduced tiny model's tables: the port's with
  serving hot sets (coverage 0.95 in a budget, ``state_copies=0``, as the
  JAX bench sizes them), the port's without, and JAX's with them."""
  pcfg = torch_parity.reduced(synthetic, 'tiny', 2000)
  jcfg = torch_parity.reduced(jax_synthetic, 'tiny', 2000)
  jt, itm, hot = jax_synthetic.expand_tables(jcfg)
  pt, _, _ = synthetic.expand_tables(pcfg)
  jd = JaxDistributedEmbedding(jt, input_table_map=itm,
                               mesh=torch_parity.jax_mesh(1))
  weights = jax_ckpt.get_weights(jd, jd.init(0))
  kw = dict(alpha=1.05, coverage=0.95, budget_bytes=64 << 10,
            state_copies=0)
  sets = hotcache.analytic_power_law_hot_sets(pt, **kw)
  jsets = jax_hotcache.analytic_power_law_hot_sets(jt, **kw)
  assert sets and sorted(sets) == sorted(jsets)
  je = jax_engine.ServingEngine(jt, weights, batch_size=BATCH,
                                mesh=torch_parity.jax_mesh(1),
                                input_table_map=itm, hotness=hot,
                                hot_sets=jsets)
  common = dict(batch_size=BATCH, device='cpu', input_table_map=itm,
                hotness=hot)
  pe = engine.ServingEngine(pt, weights, hot_sets=sets, **common)
  plain = engine.ServingEngine(pt, weights, **common)
  (_, cats), _ = synthetic.InputGenerator(pcfg, BATCH, alpha=1.05,
                                          num_batches=1, seed=2)[0]
  cats = torch_parity.padded_cats(cats, hot, seed=2)
  return je, pe, plain, cats, hot


@pytest.mark.parametrize('n', [1, 5, 17, 64])
def test_serving_with_hot_sets_matches_plain_and_jax(engines, n):
  je, pe, plain, cats, hot = engines
  assert pe.dist.hot_enabled and not plain.dist.hot_enabled
  req = [c[:n] for c in cats]
  got = pe.lookup_padded(req)
  torch_parity.assert_outputs_match(
      got, [o.numpy() for o in plain.lookup_padded(req)], hot)
  torch_parity.assert_outputs_match(got, je.lookup_padded(req), hot)
