"""Long-horizon convergence and AUC through the port's data path: the
counterpart of tests/test_convergence.py.

A synthetic Criteo-format split with a learnable rule is written by the
port's ``write_raw_binary_dataset`` and read back through its
``BinaryCriteoReader``; a small DLRM (the JAX model's weights carried
across, ``DLRM.load_jax_params``) trains for 512 steps (two epochs) on
the CPU:

- the sparse hybrid step and the dense autodiff step from the same
  init: the loss descends for both, the two end at near-identical
  embedding weights (SGD's sparse update is exact), the held-out AUC
  clears the rule's bar for both, and the trainers' AUCs, and the
  sparse trainer's against the JAX package's sparse trainer run on the
  same data, agree within the reference's parity bar (0.005);
- sparse Adagrad at an f32 and a bf16 accumulator: both clear the bar,
  within 0.005 of each other and of JAX's run at that dtype;
- (``slow``) three init seeds: the AUC improves over checkpoints and the
  trainers end within 0.005.

The JAX test's bounds, unchanged.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.models import dlrm as jax_dlrm
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.models.dlrm import DLRM, bce_with_logits
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import grad
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.utils.data import (
    BinaryCriteoReader, write_raw_binary_dataset)
from distributed_embeddings_tpu_torch.utils.metrics import (StreamingAUC,
                                                            exact_auc)

import torch_parity

torch.set_num_threads(1)

TABLE_SIZES = [64, 128, 32, 100]
NUM_F = 4
BATCH = 64
STEPS = 512  # 2 epochs over the 16384-row train split
LR = 0.3
SMALL = dict(embedding_dim=8, bottom_mlp_dims=[16, 8], top_mlp_dims=[16, 1],
             num_numerical_features=NUM_F)


def _make_split(rng, n):
  """Learnable rule: logit from two categorical parities + one numerical."""
  cats = [rng.integers(0, s, n).astype(np.int64) for s in TABLE_SIZES]
  numerical = rng.normal(size=(n, NUM_F)).astype(np.float16)
  logit = (1.5 * (cats[0] % 2) + 1.0 * (cats[1] % 3 == 0) - 1.2 +
           0.8 * numerical[:, 0].astype(np.float32))
  p = 1.0 / (1.0 + np.exp(-logit))
  labels = (rng.random(n) < p).astype(np.bool_)
  return labels, numerical, cats


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
  root = tmp_path_factory.mktemp('criteo_synth')
  rng = np.random.default_rng(17)
  write_raw_binary_dataset(str(root), 'train', *_make_split(rng, 16384),
                           TABLE_SIZES)
  write_raw_binary_dataset(str(root), 'test', *_make_split(rng, 1024),
                           TABLE_SIZES)
  return str(root)


def _reader(path, valid=False):
  return BinaryCriteoReader(path, batch_size=BATCH, numerical_features=NUM_F,
                            categorical_features=list(
                                range(len(TABLE_SIZES))),
                            categorical_feature_sizes=TABLE_SIZES,
                            prefetch_depth=2, drop_last_batch=True,
                            valid=valid)


def _models(seed=0):
  """The JAX model (one-device mesh, initialised from ``seed``) and the
  port's twin holding its weights."""
  jm = jax_dlrm.DLRM(table_sizes=TABLE_SIZES, mesh=torch_parity.jax_mesh(1),
                     **SMALL)
  jparams = jm.init(seed)
  pm = DLRM(TABLE_SIZES, device='cpu', **SMALL)
  pm.load_jax_params(
      jax_ckpt.get_weights(jm.dist_embedding, jparams['embedding']),
      jax.tree.map(np.asarray, {k: v for k, v in jparams.items()
                                if k != 'embedding'}))
  return jm, jparams, pm


def _params(pm):
  """A fresh copy of the port model's params (the trainers update theirs
  in place)."""
  return {'embedding': {k: v.clone()
                        for k, v in pm.embedding_params.items()},
          **{k: v.detach().clone() for k, v in pm.dense_params().items()}}


def _eval_auc(model, params, path):
  ds = _reader(path, valid=True)
  auc = StreamingAUC()
  all_l, all_p = [], []
  with torch.no_grad():
    for i in range(len(ds)):
      num, cats, labels = ds[i]
      preds = torch.sigmoid(model.apply(params, num, list(cats)))[:, 0]
      preds = preds.numpy()
      auc.update(labels[:, 0], preds)
      all_l.append(labels[:, 0])
      all_p.append(preds)
  ds.close()
  streaming = auc.result()
  exact = exact_auc(np.concatenate(all_l), np.concatenate(all_p))
  assert abs(streaming - exact) < 5e-3, (streaming, exact)
  return exact


def _jax_eval_auc(jm, jparams, path):
  ds = _reader(path, valid=True)
  labels_all, preds_all = [], []
  for i in range(len(ds)):
    num, cats, labels = ds[i]
    logits = jm.apply(jparams, jnp.asarray(num),
                      [jnp.asarray(c) for c in cats])
    preds_all.append(np.asarray(jax.nn.sigmoid(logits))[:, 0])
    labels_all.append(labels[:, 0])
  ds.close()
  return exact_auc(np.concatenate(labels_all), np.concatenate(preds_all))


def _head_loss(model):
  def head_loss_fn(dense_params, emb_outs, hbatch):
    numerical, labels = hbatch
    return bce_with_logits(model.head(dense_params, numerical, emb_outs),
                           torch.as_tensor(labels))
  return head_loss_fn


def _jax_sparse_run(jm, jparams, ds, emb_opt, dense_opt, steps):
  def head_loss_fn(dense_params, emb_outs, hbatch):
    numerical, labels = hbatch
    return jax_dlrm.bce_with_logits(
        jm.head(dense_params, numerical, emb_outs), labels)

  state = jax_sparse.init_hybrid_train_state(
      jm.dist_embedding, jax.tree.map(jnp.copy, jparams), dense_opt, emb_opt)
  step = jax_sparse.make_hybrid_train_step(jm.dist_embedding, head_loss_fn,
                                           dense_opt, emb_opt, donate=False)
  for s in range(steps):
    num, cats, labels = ds[s % len(ds)]
    state, _ = step(state, [jnp.asarray(c) for c in cats],
                    (jnp.asarray(num), jnp.asarray(labels)))
  return state


def _descends(losses, bar):
  head = float(np.mean(losses[:16]))
  tail = float(np.mean(losses[-16:]))
  assert tail < head * bar, (head, tail)
  assert np.isfinite(losses).all()


def test_sparse_and_dense_trainers_converge_to_same_auc(dataset):
  jm, jparams, model = _models(0)
  ds = _reader(dataset)
  n_batches = len(ds)
  dist = model.dist_embedding

  # --- the sparse hybrid trainer -----------------------------------------
  emb_opt = sparse.SparseSGD(learning_rate=LR)
  sstate = sparse.init_hybrid_train_state(dist, _params(model),
                                          optim.sgd(LR), emb_opt)
  sstep = sparse.make_hybrid_train_step(dist, _head_loss(model),
                                        optim.sgd(LR), emb_opt)
  sparse_losses = []
  for s in range(STEPS):
    num, cats, labels = ds[s % n_batches]
    sstate, loss = sstep(sstate, list(cats), (num, labels))
    sparse_losses.append(float(loss))

  # --- the dense autodiff trainer ----------------------------------------
  def loss_fn(p, batch):
    numerical, cats, labels = batch
    return bce_with_logits(model.apply(p, numerical, list(cats)),
                           torch.as_tensor(labels))

  dstep = grad.make_train_step(loss_fn, optim.sgd(LR))
  dstate = grad.init_train_state(_params(model), optim.sgd(LR))
  dense_losses = []
  for s in range(STEPS):
    num, cats, labels = ds[s % n_batches]
    dstate, loss = dstep(dstate, (num, tuple(cats), labels))
    dense_losses.append(float(loss))
  ds.close()

  # the JAX test's descent bar (its measured tail/head is 0.856)
  for losses in (sparse_losses, dense_losses):
    _descends(losses, 0.88)

  sw = checkpoint.get_weights(dist, sstate.params['embedding'])
  dw = checkpoint.get_weights(dist, dstate.params['embedding'])
  for t, (a, b) in enumerate(zip(sw, dw)):
    np.testing.assert_allclose(a.numpy(), b.detach().numpy(), rtol=5e-3,
                               atol=5e-4,
                               err_msg=f'table {t} after {STEPS} steps')

  auc_sparse = _eval_auc(model, sstate.params, dataset)
  auc_dense = _eval_auc(model, dstate.params, dataset)
  assert auc_sparse > 0.74, auc_sparse
  assert auc_dense > 0.74, auc_dense
  assert abs(auc_sparse - auc_dense) < 0.005, (auc_sparse, auc_dense)

  # the JAX package's sparse trainer on the same data from the same init
  jstate = _jax_sparse_run(jm, jparams, _reader(dataset),
                           jax_sparse.SparseSGD(learning_rate=LR),
                           optax.sgd(LR), STEPS)
  auc_jax = _jax_eval_auc(jm, jstate.params, dataset)
  assert abs(auc_sparse - auc_jax) < 0.005, (auc_sparse, auc_jax)


_ACCUM_AUC = {}


@pytest.mark.parametrize('accum_dtype', ['float32', 'bfloat16'])
def test_adagrad_accum_dtype_converges(dataset, accum_dtype):
  jm, jparams, model = _models(0)
  ds = _reader(dataset)
  n_batches = len(ds)
  dist = model.dist_embedding
  emb_opt = sparse.SparseAdagrad(learning_rate=0.1, accum_dtype=accum_dtype)
  dense_opt = optim.adagrad(0.1, initial_accumulator_value=0.1, eps=1e-7)
  state = sparse.init_hybrid_train_state(dist, _params(model), dense_opt,
                                         emb_opt)
  step = sparse.make_hybrid_train_step(dist, _head_loss(model), dense_opt,
                                       emb_opt)
  losses = []
  for s in range(STEPS):
    num, cats, labels = ds[s % n_batches]
    state, loss = step(state, list(cats), (num, labels))
    losses.append(float(loss))
  ds.close()
  _descends(losses, 0.9)  # the JAX test's Adagrad bar
  want = getattr(torch, accum_dtype)
  for leaves in state.opt_state[1].values():
    assert leaves['acc'].dtype == want, accum_dtype
  auc = _eval_auc(model, state.params, dataset)
  assert auc > 0.74, (accum_dtype, auc)
  _ACCUM_AUC[accum_dtype] = auc
  if len(_ACCUM_AUC) == 2:
    assert abs(_ACCUM_AUC['float32'] - _ACCUM_AUC['bfloat16']) < 0.005, \
        _ACCUM_AUC
  jstate = _jax_sparse_run(
      jm, jparams, _reader(dataset),
      jax_sparse.SparseAdagrad(learning_rate=0.1, accum_dtype=accum_dtype),
      optax.adagrad(0.1, initial_accumulator_value=0.1, eps=1e-7), STEPS)
  auc_jax = _jax_eval_auc(jm, jstate.params, dataset)
  assert abs(auc - auc_jax) < 0.005, (accum_dtype, auc, auc_jax)


@pytest.mark.slow  # three seeds of the pair the tier-1 test pins for one
def test_multi_seed_auc_parity_and_improvement(dataset):
  ds = _reader(dataset)
  n_batches = len(ds)
  phases, phase_steps = 3, 64
  for seed in (1, 2, 3):
    _, _, model = _models(seed)
    dist = model.dist_embedding
    emb_opt = sparse.SparseSGD(learning_rate=LR)
    sstate = sparse.init_hybrid_train_state(dist, _params(model),
                                            optim.sgd(LR), emb_opt)
    sstep = sparse.make_hybrid_train_step(dist, _head_loss(model),
                                          optim.sgd(LR), emb_opt)

    def loss_fn(p, batch):
      numerical, cats, labels = batch
      return bce_with_logits(model.apply(p, numerical, list(cats)),
                             torch.as_tensor(labels))

    dstep = grad.make_train_step(loss_fn, optim.sgd(LR))
    dstate = grad.init_train_state(_params(model), optim.sgd(LR))
    aucs = [_eval_auc(model, sstate.params, dataset)]
    step = 0
    for _ in range(phases):
      for _ in range(phase_steps):
        num, cats, labels = ds[step % n_batches]
        sstate, _ = sstep(sstate, list(cats), (num, labels))
        dstate, _ = dstep(dstate, (num, tuple(cats), labels))
        step += 1
      aucs.append(_eval_auc(model, sstate.params, dataset))
    for a, b in zip(aucs, aucs[1:]):
      assert b >= a - 0.005, (seed, aucs)
    assert aucs[-1] > aucs[0] + 0.02, (seed, aucs)
    auc_dense = _eval_auc(model, dstate.params, dataset)
    assert abs(aucs[-1] - auc_dense) < 0.005, (seed, aucs[-1], auc_dense)
  ds.close()
