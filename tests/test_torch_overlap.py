"""The chunked exchange/compute overlap (item 8, ``overlap_chunks``) and
the per-group exchange schedule (``fused_exchange=False``) on the port,
on the CPU, world of one (the JAX side on a one-device mesh with natural
storage, so both plan the same tables).  Data is drawn with numpy from a
seed.

- ``parallel/overlap.py``: ``chunk_bounds``, ``effective_chunks``,
  ``overlap_pct`` and ``a2a_overlap_stats`` equal JAX's over a grid; the
  planner's ``GroupSpec.overlap_chunks`` and fingerprints equal JAX's;
  the exchange-only program sums what JAX's sums.
- The refusal matrix of the constructor, with JAX's exception types and
  messages (row-sliced tables, which a world of one does not slice, on
  two ranks: tests/test_torch_overlap_ranks.py).
- The chunked layer against the unchunked one, bit for bit: the forward
  at every hotness, the residuals, ``backward_to_mp`` and the tables,
  accumulators and losses after 3 ``SparseAdagrad`` steps; with hot sets
  the forward and 3 ``SparseAdagrad`` and ``SparseAdam`` steps; and
  ``grad.make_train_step`` (one ``lookup_grad`` a group and step).
  Against the JAX chunked layer: the forward bit-exact at hotness 1 and
  within rtol = atol = 1e-6 above; the steps within rtol 3e-5 / atol
  3e-6 (tests/test_sparse_train.py's Adagrad bound).
- Round ``k``'s id exchange is issued before round ``k-1``'s lookups
  run (the order of the calls, recorded).
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import hotcache as jax_hotcache
from distributed_embeddings_tpu.parallel import overlap as jax_overlap
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.ops import lookup as lookup_ops
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import grad
from distributed_embeddings_tpu_torch.parallel import hotcache
from distributed_embeddings_tpu_torch.parallel import overlap
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

import torch_parity

torch.set_num_threads(1)

# (rows, width, combiner); inputs share tables 0, 2 and 4, so rows two
# slots share meet in one stream
SPECS = [(40, 4, 'sum'), (30, 4, 'sum'), (50, 4, 'sum'), (25, 4, 'sum'),
         (60, 8, 'mean'), (45, 8, 'mean'), (35, 8, 'mean'), (20, 4, None),
         (55, 4, None)]
INPUT_MAP = [0, 1, 2, 3, 0, 4, 5, 6, 4, 7, 8, 2]
HOTNESS = [1, 3, 1, 3, 1, 2, 2, 2, 1, 1, 1, 3]
HOT_IDS = {0: [0, 1, 2, 5], 2: list(range(10)), 4: [3, 7], 8: [1, 54]}
BATCH = 16
LR = 0.05


def _configs(jax_side=False):
  cls = jax_planner.TableConfig if jax_side else TableConfig
  return [cls(r, w, combiner=c) for r, w, c in SPECS]


def _hot(jax_side=False):
  cls = jax_hotcache.HotSet if jax_side else hotcache.HotSet
  return {t: cls(t, np.asarray(v)) for t, v in HOT_IDS.items()}


def _case(n_batches, seed=0):
  rng = np.random.default_rng(seed)
  weights = [(rng.normal(size=(r, w)) * 0.1).astype(np.float32)
             for r, w, _ in SPECS]
  kernel = (rng.normal(size=(sum(SPECS[t][1] for t in INPUT_MAP), 1))
            * 0.1).astype(np.float32)
  labels = rng.normal(size=(BATCH, 1)).astype(np.float32)
  batches = []
  for _ in range(n_batches):
    cats = []
    for t, h in zip(INPUT_MAP, HOTNESS):
      rows = SPECS[t][0]
      x = rng.integers(0, rows, size=(BATCH, h)).astype(np.int32)
      if h > 1:
        keep = rng.integers(1, h + 1, size=(BATCH, 1))
        x[np.arange(h)[None, :] >= keep] = -1
      x[rng.integers(0, BATCH), 0] = rows + 2      # out of vocab
      cats.append(x[:, 0] if h == 1 else x)
    batches.append(cats)
  return weights, kernel, labels, batches


def _port(chunks, hot=False, **kw):
  return DistributedEmbedding(_configs(), device='cpu',
                              input_table_map=INPUT_MAP,
                              overlap_chunks=chunks,
                              hot_cache=_hot() if hot else None, **kw)


def _jax(chunks, hot=False, **kw):
  return JaxDistributedEmbedding(
      _configs(jax_side=True), mesh=torch_parity.jax_mesh(1),
      input_table_map=INPUT_MAP, packed_storage=False,
      overlap_chunks=chunks, hot_cache=_hot(True) if hot else None, **kw)


def _equal(a, b, what):
  assert len(a) == len(b), what
  for i, (x, y) in enumerate(zip(a, b)):
    assert x.dtype == y.dtype and torch.equal(x, y), f'{what} {i}'


# ------------------------------------------------------------- overlap.py


def test_chunk_geometry_and_metric_match_jax():
  for n in range(0, 30):
    for k in range(1, 12):
      assert overlap.effective_chunks(k, n) == jax_overlap.effective_chunks(
          k, n)
      if n:
        assert overlap.chunk_bounds(n, k) == jax_overlap.chunk_bounds(n, k)
  assert overlap.chunk_bounds(26, 4) == [(0, 7), (7, 14), (14, 20),
                                         (20, 26)]
  for off, on, ex in ((10.0, 8.0, 4.0), (10.0, 12.0, 4.0), (5.0, 1.0, 2.0),
                      (3.0, 2.0, 0.0), (7.25, 7.0, 0.5)):
    assert overlap.overlap_pct(off, on, ex) == jax_overlap.overlap_pct(
        off, on, ex)
    assert (overlap.a2a_overlap_stats(off, on, ex, 4, [4, 1, 4, 2],
                                      [1.0, 2.5])
            == jax_overlap.a2a_overlap_stats(off, on, ex, 4, [4, 1, 4, 2],
                                             [1.0, 2.5]))


@pytest.mark.parametrize('chunks', [1, 2, 3, 5, 7])
def test_group_chunks_and_fingerprint_match_jax(chunks):
  for hot in (False, True):
    pd, jd = _port(chunks, hot), _jax(chunks, hot)
    assert pd.overlap_chunks == jd.plan.overlap_chunks == chunks
    assert ([g.overlap_chunks for g in pd.plan.groups]
            == [g.overlap_chunks for g in jd.plan.groups]
            == overlap.group_chunk_counts(pd.plan))
    assert pd.plan.fingerprint() == jd.plan.fingerprint()
  if chunks > 1:
    assert _port(1).plan.fingerprint() != _port(chunks).plan.fingerprint()


def test_exchange_program_sums_what_jax_sums():
  _, _, _, (cats,) = _case(1)
  for chunks in (1, 3):
    for rows_only in (False, True):
      fn, inputs = overlap.build_exchange_program(_port(chunks), cats,
                                                  rows_only=rows_only)
      jfn, jinputs = jax_overlap.build_exchange_program(
          _jax(chunks), [jnp.asarray(c) for c in cats], rows_only=rows_only)
      np.testing.assert_allclose(float(fn(*inputs)), float(jfn(*jinputs)),
                                 rtol=1e-6)
  ms = overlap.measure_exchange_ms(_port(3), cats, repeats=2)
  assert np.isfinite(ms) and ms >= 0
  with pytest.raises(ValueError, match='dp_input layer'):
    overlap.build_exchange_program(
        DistributedEmbedding(_configs(), device='cpu', dp_input=False),
        cats)


# ---------------------------------------------------------------- refusals


def _refusal(kw, port):
  tables = ([TableConfig(1000, 8, 'sum'), TableConfig(20, 8, 'sum')] if port
            else [jax_planner.TableConfig(1000, 8, 'sum'),
                  jax_planner.TableConfig(20, 8, 'sum')])
  if port:
    return DistributedEmbedding(tables, device='cpu', **kw)
  return JaxDistributedEmbedding(tables, mesh=torch_parity.jax_mesh(1),
                                 packed_storage=False, **kw)


@pytest.mark.parametrize('kw', [
    dict(overlap_chunks=2, dp_input=False),
    dict(overlap_chunks=0),
    dict(overlap_chunks=True),
    dict(overlap_chunks=1.5),
])
def test_refusals_match_jax(kw):
  with pytest.raises(ValueError) as want:
    _refusal(kw, port=False)
  with pytest.raises(ValueError) as got:
    _refusal(kw, port=True)
  assert str(got.value) == str(want.value)


def test_row_sliced_layer_with_hot_cache_chunks():
  # the JAX matrix allows it: the cached forward's row shards ride the
  # chunked slot exchange
  hot = {0: hotcache.HotSet(0, np.arange(5))}
  pd = DistributedEmbedding([TableConfig(1000, 8, 'sum'),
                             TableConfig(20, 8, 'sum')], device='cpu',
                            overlap_chunks=3, row_slice=1000, hot_cache=hot)
  off = DistributedEmbedding([TableConfig(1000, 8, 'sum'),
                              TableConfig(20, 8, 'sum')], device='cpu',
                             row_slice=1000, hot_cache=hot)
  rng = np.random.default_rng(3)
  weights = [rng.normal(size=(1000, 8)).astype(np.float32),
             rng.normal(size=(20, 8)).astype(np.float32)]
  cats = [rng.integers(0, 1000, (8, 2)).astype(np.int32),
          rng.integers(0, 20, (8,)).astype(np.int32)]
  _equal(pd.apply(checkpoint.set_weights(pd, weights), cats),
         off.apply(checkpoint.set_weights(off, weights), cats), 'output')


# ------------------------------------------- chunked against unchunked


def _port_step(pd, weights, kernel, labels, batches, emb_opt):
  def head(dense_params, emb_outs, labels):
    x = torch.cat(list(emb_outs), dim=1)
    return torch.mean((x @ dense_params['kernel']
                       - torch.as_tensor(labels))**2)

  dense_opt = optim.sgd(LR)
  state = sparse.init_hybrid_train_state(
      pd, {'embedding': checkpoint.set_weights(pd, weights),
           'kernel': torch.tensor(kernel)}, dense_opt, emb_opt)
  step = sparse.make_hybrid_train_step(pd, head, dense_opt, emb_opt)
  losses = []
  for cats in batches:
    state, loss = step(state, cats, labels)
    losses.append(loss)
  return (checkpoint.get_weights(pd, state.params['embedding']),
          checkpoint.get_optimizer_state(pd, state.opt_state[1]),
          state.params['kernel'], torch.stack(losses))


def _jax_step(jd, weights, kernel, labels, batches, emb_opt):
  def head(dense_params, emb_outs, labels):
    x = jnp.concatenate(list(emb_outs), axis=1)
    return jnp.mean((x @ dense_params['kernel'] - labels)**2)

  dense_opt = optax.sgd(LR)
  state = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': jax_ckpt.set_weights(jd, weights),
           'kernel': jnp.asarray(kernel)}, dense_opt, emb_opt)
  step = jax_sparse.make_hybrid_train_step(jd, head, dense_opt, emb_opt,
                                           donate=False)
  losses = []
  for cats in batches:
    state, loss = step(state, [jnp.asarray(c) for c in cats],
                       jnp.asarray(labels))
    losses.append(float(loss))
  return (jax_ckpt.get_weights(jd, state.params['embedding']),
          jax_ckpt.get_optimizer_state(jd, state.opt_state[1]),
          np.asarray(losses))


def _same_state(a, b):
  wa, sa, ka, la = a
  wb, sb, kb, lb = b
  _equal(wa, wb, 'table')
  for x, y in zip(sa, sb):
    assert sorted(x) == sorted(y)
    _equal([x[k] for k in sorted(x)], [y[k] for k in sorted(y)], 'state')
  assert torch.equal(ka, kb) and torch.equal(la, lb)


@pytest.mark.parametrize('chunks', [2, 3, 5])
def test_chunked_equals_unchunked(chunks):
  weights, kernel, labels, batches = _case(3, seed=chunks)
  mono, chunked = _port(1), _port(chunks)
  pm = checkpoint.set_weights(mono, weights)
  pc = checkpoint.set_weights(chunked, weights)
  with torch.no_grad():
    om, rm, sig = mono.forward_with_residuals(pm, batches[0])
    oc, rc, sigc = chunked.forward_with_residuals(pc, batches[0])
  assert sig == sigc
  assert chunked.lookup_plan().chunks == min(chunks, 3) > 1
  _equal(om, oc, 'output')
  _equal(rm, rc, 'residual')
  rng = np.random.default_rng(chunks)
  d_outs = [torch.as_tensor(rng.normal(size=o.shape).astype(np.float32))
            for o in om]
  _equal(mono.backward_to_mp(d_outs, *sig),
         chunked.backward_to_mp(d_outs, *sig), 'grad')
  opt = sparse.SparseAdagrad(LR)
  _same_state(_port_step(mono, weights, kernel, labels, batches, opt),
              _port_step(chunked, weights, kernel, labels, batches, opt))


@pytest.mark.parametrize('opt', [sparse.SparseAdagrad(LR),
                                 sparse.SparseAdam(0.01)],
                         ids=['adagrad', 'adam'])
def test_hot_chunked_equals_unchunked(opt):
  weights, kernel, labels, batches = _case(3, seed=7)
  mono, chunked = _port(1, hot=True), _port(3, hot=True)
  with torch.no_grad():
    _equal(mono.apply(checkpoint.set_weights(mono, weights), batches[0]),
           chunked.apply(checkpoint.set_weights(chunked, weights),
                         batches[0]), 'output')
  assert chunked.lookup_plan().chunks == 3
  _same_state(_port_step(mono, weights, kernel, labels, batches, opt),
              _port_step(chunked, weights, kernel, labels, batches, opt))


@pytest.mark.parametrize('hot', [False, True], ids=['uncached', 'cached'])
def test_chunked_matches_jax(hot):
  weights, kernel, labels, batches = _case(3, seed=11)
  pd, jd = _port(3, hot), _jax(3, hot)
  with torch.no_grad():
    got = pd.apply(checkpoint.set_weights(pd, weights), batches[0])
  want = jd.apply(jax_ckpt.set_weights(jd, weights),
                  [jnp.asarray(c) for c in batches[0]])
  torch_parity.assert_outputs_match(got, want, HOTNESS)
  opt = sparse.SparseAdagrad(LR)
  gw, gs, _, gl = _port_step(pd, weights, kernel, labels, batches, opt)
  ww, ws, wl = _jax_step(jd, weights, kernel, labels, batches,
                         jax_sparse.SparseAdagrad(LR))
  for t, (g, w) in enumerate(zip(gw, ww)):
    np.testing.assert_allclose(g.numpy(), w, rtol=3e-5, atol=3e-6,
                               err_msg=f'table {t}')
  for t, (g, w) in enumerate(zip(gs, ws)):
    np.testing.assert_allclose(g['acc'].numpy(), w['acc'], rtol=3e-5,
                               atol=3e-6, err_msg=f'accumulator {t}')
  np.testing.assert_allclose(gl.numpy(), wl, rtol=3e-5, atol=3e-6)


def test_dense_step_chunked_equals_unchunked(monkeypatch):
  weights, kernel, labels, batches = _case(2, seed=5)
  calls = []
  real = lookup_ops.lookup_grad

  def counted(*a, **k):
    calls.append(1)
    return real(*a, **k)

  monkeypatch.setattr(lookup_ops, 'lookup_grad', counted)
  results = {}
  for chunks in (1, 3):
    pd = _port(chunks)

    def loss_fn(params, batch, pd=pd):
      cats, y = batch
      x = torch.cat(pd.apply(params['embedding'], cats), dim=1)
      return torch.mean((x @ params['kernel'] - torch.as_tensor(y))**2)

    opt = optim.adagrad(LR)
    params = {'embedding': checkpoint.set_weights(pd, weights),
              'kernel': torch.tensor(kernel)}
    state = grad.init_train_state(params, opt)
    step = grad.make_train_step(loss_fn, opt)
    losses = []
    del calls[:]
    for cats in batches:
      state, loss = step(state, (cats, labels))
      losses.append(loss)
    # one table gradient a fusion group and step, chunked or not
    assert len(calls) == len(pd.plan.groups) * len(batches)
    results[chunks] = (checkpoint.get_weights(pd,
                                              state.params['embedding']),
                       state.params['kernel'], torch.stack(losses))
  _equal(results[1][0], results[3][0], 'table')
  assert torch.equal(results[1][1], results[3][1])
  assert torch.equal(results[1][2], results[3][2])


def test_issue_before_compute_order(monkeypatch):
  """Round k's id exchange is issued before round k-1's lookups: the
  recorded calls of a 3-round forward."""
  _, _, _, (cats,) = _case(1)
  pd = _port(3)
  events = []
  issue, fused = DistributedEmbedding._issue, lookup_ops.fused_group_lookup

  def rec_issue(self, bufs, name, plan=None):
    events.append(name)
    return issue(self, bufs, name, plan)

  def rec_lookup(*a, **k):
    events.append('lookup')
    return fused(*a, **k)

  monkeypatch.setattr(DistributedEmbedding, '_issue', rec_issue)
  monkeypatch.setattr(lookup_ops, 'fused_group_lookup', rec_lookup)
  with torch.no_grad():
    pd.apply(checkpoint.set_weights(pd, _case(1)[0]), cats)
  squeezed = [e for i, e in enumerate(events)
              if i == 0 or e != 'lookup' or events[i - 1] != 'lookup']
  assert squeezed == ['fwd/ids', 'fwd/ids', 'lookup', 'fwd/rows',
                      'fwd/ids', 'lookup', 'fwd/rows', 'lookup', 'fwd/rows']


def test_fused_exchange_false_builds_and_equals():
  _, _, _, (cats,) = _case(1)
  weights = _case(1)[0]
  on, off = _port(3), _port(3, fused_exchange=False)
  assert on.fused_exchange and not off.fused_exchange
  with torch.no_grad():
    _equal(on.apply(checkpoint.set_weights(on, weights), cats),
           off.apply(checkpoint.set_weights(off, weights), cats), 'output')
  assert on.lookup_plan().fused and not off.lookup_plan().fused
