"""``DistEmbed``, the port's ``torch.nn.Module`` over the distributed
runtime, case for case with tests/test_flax_adapter.py (the JAX
package's linen ``DistEmbed``): the module equals the runtime on its own
tables and its parameters have the runtime's group structure; it trains
as an ordinary module (plain autograd and ``torch.optim``); the sparse
hybrid step trains the same tables through ``tables_of`` /
``merge_tables`` under ``grad.fit``; and the "exactly one" checks.
Against the linen module on a one-device mesh, from the same weights:
outputs bit-exact at hotness 1 and rtol = atol = 1e-6 above, table
gradients rtol 1e-5 / atol 1e-6."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from distributed_embeddings_tpu.layers.flax_embedding import (
    DistEmbed as JaxDistEmbed, merge_tables as jax_merge_tables,
    tables_of as jax_tables_of)
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.layers.dist_embed import (
    TABLES, DistEmbed, merge_tables, tables_of)
from distributed_embeddings_tpu_torch.parallel import checkpoint, grad, sparse
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

import torch_parity

torch.set_num_threads(1)

BATCH = 16
SPECS = [(40, 4, None), (30, 4, 'sum'), (50, 8, 'mean')]
HOT = [1, 3, 2]


def make_inputs(rng, batch=BATCH):
  return [rng.integers(0, r, (batch,) if h == 1 else (batch, h)).astype(
      np.int32) for (r, _, _), h in zip(SPECS, HOT)]


def build(**kw):
  return DistEmbed.build([TableConfig(r, w, combiner=c)
                          for r, w, c in SPECS], device='cpu',
                         strategy='memory_balanced', **kw)


def test_wrapper_matches_runtime_and_jax():
  m = build()
  cats = make_inputs(np.random.default_rng(0))
  tables = tables_of(m.state_dict())
  direct = m.dist.init(0)
  assert sorted(tables) == sorted(direct)
  for k in direct:
    assert tables[k].shape == direct[k].shape
    assert tables[k].dtype == direct[k].dtype
    assert torch.equal(tables[k], direct[k])
  assert all(isinstance(p, nn.Parameter) for p in m.tables.values())
  outs = m(cats)
  for o, e in zip(outs, m.dist.apply(tables, cats)):
    assert torch.equal(o, e)

  # the linen module on one device, from the same weights
  jm = JaxDistEmbed.build([jax_planner.TableConfig(r, w, combiner=c)
                           for r, w, c in SPECS],
                          mesh=torch_parity.jax_mesh(1),
                          strategy='memory_balanced', packed_storage=False)
  jcats = [jnp.asarray(c) for c in cats]
  variables = jm.init(jax.random.key(0), jcats)
  weights = [w.numpy() for w in checkpoint.get_weights(m.dist, tables)]
  variables = jax_merge_tables(variables, jax_ckpt.set_weights(jm.dist,
                                                               weights))
  want = jm.apply(variables, jcats)
  torch_parity.assert_outputs_match(outs, want, HOT)

  # the tables' gradient of one fixed linear loss
  rng = np.random.default_rng(1)
  proj = rng.normal(size=(BATCH, sum(w for _, w, _ in SPECS))).astype(
      np.float32)
  torch.sum(torch.cat(m(cats), 1) * torch.as_tensor(proj)).backward()
  got = checkpoint.get_weights(m.dist, {k: p.grad for k, p in
                                        m.tables.items()})
  g = jax.grad(lambda v: jnp.sum(jnp.concatenate(jm.apply(v, jcats), 1)
                                 * proj))(variables)
  for a, b in zip(got, jax_ckpt.get_weights(jm.dist, jax_tables_of(g))):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                               atol=1e-6)


class _Model(nn.Module):
  """DistEmbed + dense head: the migration target shape."""

  def __init__(self, emb):
    super().__init__()
    self.emb = emb
    self.hidden = nn.Linear(sum(w for _, w, _ in SPECS), 16)
    self.out = nn.Linear(16, 1)

  def forward(self, cats):
    x = torch.cat(self.emb(cats), dim=-1)
    return self.out(torch.relu(self.hidden(x)))[:, 0]


def _batches(seed, n, batch=BATCH):
  rng = np.random.default_rng(seed)
  for _ in range(n):
    cats = make_inputs(rng, batch)
    # label depends on the first table's id: learnable through the tables
    yield cats, torch.as_tensor(cats[0] % 2, dtype=torch.float32)


def test_plain_autograd_training():
  """The module trains as an ordinary one: torch.optim over
  ``parameters()``, dense table gradients, loss decreases."""
  torch.manual_seed(0)
  model = _Model(build())
  cats0, y0 = next(_batches(1, 1))
  bce = nn.functional.binary_cross_entropy_with_logits
  bce(model(cats0), y0).backward()
  g_tab = tables_of({k: p.grad for k, p in model.named_parameters()})
  assert any(float(v.abs().max()) > 0 for v in g_tab.values())

  opt = torch.optim.Adam(model.parameters(), lr=1e-2)
  losses = []
  for cats, y in _batches(2, 60):
    opt.zero_grad()
    loss = bce(model(cats), y)
    loss.backward()
    opt.step()
    losses.append(float(loss.detach()))
  assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5])


def test_port_optimizer_through_dense_step():
  """The port's optax-style optimizer over the module's parameters
  (``grad.make_train_step``)."""
  torch.manual_seed(0)
  model = _Model(build())
  bce = nn.functional.binary_cross_entropy_with_logits
  names = [k for k, _ in model.named_parameters()]

  def loss_fn(params, batch):
    cats, y = batch
    return bce(torch.func.functional_call(model, params, (cats,)), y)

  opt = optim.adagrad(0.5)
  state = grad.init_train_state(
      {k: p.detach().clone() for k, p in model.named_parameters()}, opt)
  step = grad.make_train_step(loss_fn, opt)
  losses = []
  for batch in _batches(2, 60):
    state, loss = step(state, batch)
    losses.append(float(loss))
  assert sorted(state.params) == sorted(names)
  assert np.mean(losses[-5:]) < 0.5 * np.mean(losses[:5])
  # the same run with torch.optim.Adagrad on the module itself
  torch_opt = torch.optim.Adagrad(model.parameters(), lr=0.5,
                                  initial_accumulator_value=0.1)
  want = []
  for cats, y in _batches(2, 60):
    torch_opt.zero_grad()
    loss = bce(model(cats), y)
    loss.backward()
    torch_opt.step()
    want.append(float(loss.detach()))
  np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-6)


class _Head(nn.Module):
  """Dense head for the hybrid path (takes the embedding outputs)."""

  def __init__(self):
    super().__init__()
    self.hidden = nn.Linear(sum(w for _, w, _ in SPECS), 16)
    self.out = nn.Linear(16, 1)

  def forward(self, emb_outs):
    x = torch.cat(list(emb_outs), dim=-1)
    return self.out(torch.relu(self.hidden(x)))[:, 0]


def test_hybrid_step_with_head_and_fit():
  """The sparse hybrid step over the module's tables and a dense head,
  driven by ``fit``; the tables update in place, and merge back into a
  state dict for the module's own forward."""
  torch.manual_seed(0)
  m = build()
  head = _Head()
  cats0, _ = next(_batches(3, 1))
  before = {k: v.clone() for k, v in tables_of(m.state_dict()).items()}
  tables = tables_of(m.state_dict())  # shares the parameters' storage
  bce = nn.functional.binary_cross_entropy_with_logits

  def head_loss_fn(dense_params, emb_outs, y):
    params = {k[len('head.'):]: v for k, v in dense_params.items()}
    return bce(torch.func.functional_call(head, params, (emb_outs,)), y)

  dense_opt = optim.adagrad(0.05)
  emb_opt = sparse.SparseAdagrad(learning_rate=0.05)
  step = sparse.make_hybrid_train_step(m.dist, head_loss_fn, dense_opt,
                                       emb_opt)
  params = {'embedding': tables,
            **{f'head.{k}': p.detach().clone()
               for k, p in head.named_parameters()}}
  state = sparse.init_hybrid_train_state(m.dist, params, dense_opt, emb_opt)
  state, history = grad.fit(step, state, _batches(4, 60), steps=60,
                            log_every=20, verbose=False)
  assert history['step'] == [20, 40, 60]
  assert len(history['loss']) == 3
  assert history['loss'][-1] < history['loss'][0]

  new_tables = state.params['embedding']
  assert any(float((new_tables[k] - before[k]).abs().max()) > 0
             for k in before)
  # in place: the module's parameters are the updated tables
  for k, p in m.tables.items():
    assert torch.equal(p.detach(), new_tables[k])
  # merge back into a fresh module's state for its own forward
  fresh = build(seed=7)
  fresh.load_state_dict(merge_tables(fresh.state_dict(), new_tables))
  for o, e in zip(fresh(cats0), m.dist.apply(new_tables, cats0)):
    assert torch.equal(o, e)


def test_tables_of_rejects_ambiguity():
  with pytest.raises(ValueError, match='found 0'):
    tables_of({'head.weight': None})
  with pytest.raises(ValueError, match='found 0'):
    jax_tables_of({'params': {'Dense_0': {'kernel': None}}})
  two = {f'a.{TABLES}.group_0': 1, f'b.{TABLES}.group_0': 2}
  with pytest.raises(ValueError, match='found 2'):
    tables_of(two)
  with pytest.raises(ValueError, match='found 2'):
    merge_tables(two, {'group_0': 3})
  with pytest.raises(ValueError, match='found 2'):
    jax_tables_of({'a': {TABLES: {'group_0': 1}},
                   'b': {TABLES: {'group_0': 2}}})
  one = {f'emb.{TABLES}.group_0': 1, 'head.weight': 2}
  assert tables_of(one) == {'group_0': 1}
  assert merge_tables(one, {'group_0': 5}) == {
      f'emb.{TABLES}.group_0': 5, 'head.weight': 2}
  with pytest.raises(KeyError):
    merge_tables(one, {'group_9': 5})


def test_linen_module_shape_of_the_jax_package():
  """The JAX package's adapter is a linen module (the port's is an
  ``nn.Module`` with the same TABLES key)."""
  assert issubclass(JaxDistEmbed, fnn.Module)
  assert issubclass(DistEmbed, nn.Module)
  m = build()
  assert all(k.startswith(f'{TABLES}.') for k in m.state_dict())
