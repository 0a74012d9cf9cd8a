"""One rank of the port's multi-rank forward (``run``, for
tests/test_torch_exchange.py), hybrid train step (``train``, for
tests/test_torch_train_ranks.py), model-parallel-input forward and
step (``mp``, for tests/test_torch_mp_input.py), dense autodiff step
(``dense``, for tests/test_torch_dense_ranks.py), ragged inputs
through all three (``ragged``, for tests/test_torch_ragged_dist.py;
``ragged_run`` is the world of one's and each rank's body there) or a
hot-cache layer (``hot``, for tests/test_torch_hotcache_ranks.py): joins a gloo world on
the CPU, runs on its slice of the batch and saves what it got.  Imports
nothing of JAX (spawned processes import only this)."""

import json
import pickle


def run(rank, world_size, init_method, case_path, out_dir):
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding)
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu')
  try:
    tables = [TableConfig(r, w, combiner=c) for r, w, c in case['tables']]
    dist = DistributedEmbedding(tables, mesh=m, **case['options'])
    params = checkpoint.set_weights(dist, case['weights'])
    b = case['batch'] // world_size
    mine = [c[rank * b:(rank + 1) * b] for c in case['cats']]
    outs = dist.apply(params, mine)
    back = checkpoint.get_weights(dist, params)
    legs = [l.as_dict() for l in dist.lookup_plan().legs]
    np.savez(f'{out_dir}/rank{rank}.npz',
             *[o.numpy() for o in outs])
    np.savez(f'{out_dir}/weights{rank}.npz', *[w.numpy() for w in back])
    with open(f'{out_dir}/legs{rank}.json', 'w') as f:
      json.dump(legs, f)
    # no rank tears gloo down while the other still talks to it
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def train(rank, world_size, init_method, case_path, out_dir):
  """One rank of the port's hybrid train step, for
  tests/test_torch_train_ranks.py: steps on its slice of each batch
  with a linear head, ``SparseAdagrad`` and ``optim.adagrad``, and saves
  the gathered tables and accumulators, its head and dense state, the
  losses and the backward's exchange legs."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import grad
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import sparse
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding)
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu')
  try:
    tables = [TableConfig(r, w, combiner=c) for r, w, c in case['tables']]
    dist = DistributedEmbedding(tables, mesh=m, **case['options'])
    lr = case['lr']
    dense_opt = optim.adagrad(lr)
    emb_opt = sparse.SparseAdagrad(lr)
    # a different head on every rank until the root's is broadcast
    kernel = torch.tensor(case['kernel']) + rank
    state = sparse.init_hybrid_train_state(
        dist, {'embedding': checkpoint.set_weights(dist, case['weights']),
               'kernel': kernel}, dense_opt, emb_opt)
    grad.broadcast_variables(state.params, root_rank=0, group=m.group)

    def head_loss(dense_params, emb_outs, labels):
      x = torch.cat(list(emb_outs), dim=1)
      return torch.mean((x @ dense_params['kernel'] - labels)**2)

    step = sparse.make_hybrid_train_step(dist, head_loss, dense_opt, emb_opt)
    b = case['batch'] // world_size
    labels = torch.tensor(case['labels'][rank * b:(rank + 1) * b])
    losses = []
    for cats in case['batches']:
      state, loss = step(state, [c[rank * b:(rank + 1) * b] for c in cats],
                         labels)
      losses.append(float(loss))
    weights = checkpoint.get_weights(dist, state.params['embedding'])
    accs = checkpoint.get_optimizer_state(dist, state.opt_state[1])
    legs = [l.as_dict() for p in dist._lookup_plans.values()
            if p.path == 'bwd' for l in p.legs]
    np.savez(f'{out_dir}/train{rank}.npz',
             kernel=state.params['kernel'].numpy(),
             sos=state.opt_state[0]['sum_of_squares']['kernel'].numpy(),
             losses=np.array(losses),
             **{f'w{i}': w.numpy() for i, w in enumerate(weights)},
             **{f'a{i}': a['acc'].numpy() for i, a in enumerate(accs)})
    with open(f'{out_dir}/train_legs{rank}.json', 'w') as f:
      json.dump(legs, f)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def mp(rank, world_size, init_method, case_path, out_dir):
  """One rank of the model-parallel-input path, for
  tests/test_torch_mp_input.py: ``forward_with_residuals`` on the whole
  worker-order input list (each rank keeps its own entries), then, when
  the case carries ``train``, hybrid ``SparseSGD`` + ``optim.sgd`` steps
  with a linear head on its slice of the labels.  Saves the outputs,
  residual ids, forward legs, and the gathered tables, head and losses."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import sparse
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding)
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu')
  try:
    tables = [TableConfig(r, w, combiner=c) for r, w, c in case['tables']]
    dist = DistributedEmbedding(tables, mesh=m, dp_input=False,
                                **case['options'])
    flat = [i for dev in dist.plan.input_ids_list for i in dev]
    params = checkpoint.set_weights(dist, case['weights'])
    outs, residuals, _ = dist.forward_with_residuals(
        params, [case['cats'][i] for i in flat])
    out = {f'o{i}': o.numpy() for i, o in enumerate(outs)}
    out.update({f'r{i}': r.numpy() for i, r in enumerate(residuals)})
    legs = [l.as_dict() for l in dist.lookup_plan().legs]
    train = case.get('train')
    if train:
      dense_opt = optim.sgd(train['lr'])
      emb_opt = sparse.SparseSGD(train['lr'])
      state = sparse.init_hybrid_train_state(
          dist, {'embedding': params, 'kernel': torch.tensor(train['kernel'])},
          dense_opt, emb_opt)

      def head_loss(dense_params, emb_outs, labels):
        x = torch.cat(list(emb_outs), dim=1)
        return torch.mean((x @ dense_params['kernel'] - labels)**2)

      step = sparse.make_hybrid_train_step(dist, head_loss, dense_opt,
                                           emb_opt)
      b = case['batch'] // world_size
      labels = torch.tensor(train['labels'][rank * b:(rank + 1) * b])
      losses = []
      for cats in train['batches']:
        state, loss = step(state, [cats[i] for i in flat], labels)
        losses.append(float(loss))
      out['kernel'] = state.params['kernel'].numpy()
      out['losses'] = np.array(losses)
      out.update({f'w{i}': w.numpy() for i, w in enumerate(
          checkpoint.get_weights(dist, state.params['embedding']))})
    np.savez(f'{out_dir}/mp{rank}.npz', **out)
    with open(f'{out_dir}/mp_legs{rank}.json', 'w') as f:
      json.dump(legs, f)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def dense(rank, world_size, init_method, case_path, out_dir):
  """One rank of the port's dense autodiff step, for
  tests/test_torch_dense_ranks.py: ``grad.make_train_step`` with SGD and
  a linear head, on its slice of the batch (``dp_input``) or on the
  whole worker-order list (model-parallel input) with its slice of the
  labels; saves the gathered tables, the head and the losses."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import grad
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding)
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu')
  try:
    tables = [TableConfig(r, w, combiner=c) for r, w, c in case['tables']]
    dist = DistributedEmbedding(tables, mesh=m, dp_input=case['dp_input'],
                                **case['options'])
    params = {'embedding': checkpoint.set_weights(dist, case['weights']),
              'kernel': torch.tensor(case['kernel'])}

    def loss_fn(p, batch):
      cats, labels = batch
      x = torch.cat(dist.apply(p['embedding'], cats), dim=1)
      return torch.mean((x @ p['kernel'] - labels)**2)

    opt = optim.sgd(case['lr'])
    step = grad.make_train_step(loss_fn, opt, group=m.group)
    state = grad.init_train_state(params, opt)
    b = case['batch'] // world_size
    labels = torch.tensor(case['labels'][rank * b:(rank + 1) * b])
    flat = [i for dev in dist.plan.input_ids_list for i in dev]
    losses = []
    for cats in case['batches']:
      cats = ([c[rank * b:(rank + 1) * b] for c in cats] if case['dp_input']
              else [cats[i] for i in flat])
      state, loss = step(state, (cats, labels))
      losses.append(float(loss))
    weights = checkpoint.get_weights(dist, state.params['embedding'])
    np.savez(f'{out_dir}/dense{rank}.npz',
             kernel=state.params['kernel'].numpy(), losses=np.array(losses),
             **{f'w{i}': w.numpy() for i, w in enumerate(weights)})
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def ragged_inputs(cats, lo, hi, nnz_caps, keep_hot_cap=True):
  """The port's inputs for samples ``[lo, hi)`` of one batch of
  tests/test_torch_ragged_dist.py: a dense array as its slice, a list of
  rows as a ``RaggedBatch`` of capacity ``nnz_caps[i]`` (without its
  ``hot_cap`` unless ``keep_hot_cap``)."""
  from distributed_embeddings_tpu_torch.ops.ragged import RaggedBatch
  out = []
  for i, c in enumerate(cats):
    if isinstance(c, list):
      r = RaggedBatch.from_lists(c[lo:hi], nnz_cap=nnz_caps[i])
      out.append(r if keep_hot_cap else RaggedBatch(r.values, r.row_splits))
    else:
      out.append(c[lo:hi])
  return out


def ragged_run(dist, case, rank, world_size, group=None):
  """Ragged inputs through ``dist`` on this rank's slice of each batch:
  one ``apply``, 3 hybrid steps (``SparseAdagrad`` + ``optim.adagrad``;
  odd batches without ``hot_cap``, so the capacity comes from the
  lengths) and 3 dense steps (``optim.sgd``), each from the case's
  weights.  Returns the outputs, the gathered tables and accumulators,
  the heads and the losses as numpy."""
  import numpy as np
  import torch

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import grad
  from distributed_embeddings_tpu_torch.parallel import sparse

  b = case['batch'] // world_size
  lo, hi = rank * b, (rank + 1) * b
  caps = [c // world_size for c in case['nnz_caps']]
  labels = torch.tensor(case['labels'][lo:hi])
  out = {}
  outs = dist.apply(checkpoint.set_weights(dist, case['weights']),
                    ragged_inputs(case['batches'][0], lo, hi, caps))
  out['outs'] = [o.numpy() for o in outs]

  def head_loss(dense_params, emb_outs, y):
    x = torch.cat(list(emb_outs), dim=1)
    return torch.mean((x @ dense_params['kernel'] - y)**2)

  dense_opt, emb_opt = optim.adagrad(case['lr']), sparse.SparseAdagrad(
      case['lr'])
  state = sparse.init_hybrid_train_state(
      dist, {'embedding': checkpoint.set_weights(dist, case['weights']),
             'kernel': torch.tensor(case['kernel'])}, dense_opt, emb_opt)
  step = sparse.make_hybrid_train_step(dist, head_loss, dense_opt, emb_opt)
  losses = []
  for k, cats in enumerate(case['batches']):
    state, loss = step(state, ragged_inputs(cats, lo, hi, caps, k % 2 == 0),
                       labels)
    losses.append(float(loss))
  out['hybrid'] = {
      'weights': [w.numpy() for w in checkpoint.get_weights(
          dist, state.params['embedding'])],
      'accs': [a['acc'].numpy() for a in checkpoint.get_optimizer_state(
          dist, state.opt_state[1])],
      'kernel': state.params['kernel'].numpy(), 'losses': np.array(losses)}

  def loss_fn(p, batch):
    cats, y = batch
    x = torch.cat(dist.apply(p['embedding'], cats), dim=1)
    return torch.mean((x @ p['kernel'] - y)**2)

  opt = optim.sgd(case['lr'])
  dstep = grad.make_train_step(loss_fn, opt, group=group)
  dstate = grad.init_train_state(
      {'embedding': checkpoint.set_weights(dist, case['weights']),
       'kernel': torch.tensor(case['kernel'])}, opt)
  losses = []
  for cats in case['batches']:
    dstate, loss = dstep(dstate, (ragged_inputs(cats, lo, hi, caps), labels))
    losses.append(float(loss))
  out['dense'] = {
      'weights': [w.numpy() for w in checkpoint.get_weights(
          dist, dstate.params['embedding'])],
      'kernel': dstate.params['kernel'].numpy(), 'losses': np.array(losses)}
  return out


def ragged(rank, world_size, init_method, case_path, out_dir):
  """One rank of ``ragged_run``; saves its results (pickled)."""
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding)
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu')
  try:
    tables = [TableConfig(r, w, combiner=c) for r, w, c in case['tables']]
    dist = DistributedEmbedding(tables, mesh=m, **case['options'])
    out = ragged_run(dist, case, rank, world_size, m.group)
    with open(f'{out_dir}/ragged{rank}.pkl', 'wb') as f:
      pickle.dump(out, f)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def hot(rank, world_size, init_method, case_path, out_dir):
  """One rank of a hot-cache layer, for tests/test_torch_hotcache_ranks.py:
  the cached forward on its slice of the batch, hybrid ``SparseAdagrad``
  + ``optim.sgd`` steps with a linear head, then the auditor's replica
  check before and after rank 1's copy of a hot buffer is made to
  diverge.  Saves the outputs, the gathered tables and accumulators, the
  losses, the exchange legs and the audit findings."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import sparse
  from distributed_embeddings_tpu_torch.parallel.audit import StateAuditor
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding)
  from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu')
  try:
    tables = [TableConfig(r, w, combiner=c) for r, w, c in case['tables']]
    hot_sets = {t: HotSet(t, np.asarray(ids))
                for t, ids in case['hot'].items()}
    dist = DistributedEmbedding(tables, mesh=m, dp_input=True,
                                hot_cache=hot_sets, **case['options'])
    b = case['batch'] // world_size
    mine = lambda cats: [c[rank * b:(rank + 1) * b] for c in cats]
    params = checkpoint.set_weights(dist, case['weights'])
    outs = dist.apply(params, mine(case['cats']))
    legs = {'fwd': [l.as_dict() for l in dist.lookup_plan().legs]}
    lr = case['lr']
    dense_opt = optim.sgd(lr)
    emb_opt = sparse.SparseAdagrad(lr)
    state = sparse.init_hybrid_train_state(
        dist, {'embedding': params,
               'kernel': torch.tensor(case['kernel'])}, dense_opt, emb_opt)

    def head_loss(dense_params, emb_outs, labels):
      x = torch.cat(list(emb_outs), dim=1)
      return torch.mean((x @ dense_params['kernel'] - labels)**2)

    step = sparse.make_hybrid_train_step(dist, head_loss, dense_opt, emb_opt)
    labels = torch.tensor(case['labels'][rank * b:(rank + 1) * b])
    losses = []
    for cats in case['batches']:
      state, loss = step(state, mine(cats), labels)
      losses.append(float(loss))
    legs['bwd'] = [l.as_dict() for p in dist._lookup_plans.values()
                   if p.path == 'bwd_hot' for l in p.legs]
    weights = checkpoint.get_weights(dist, state.params['embedding'])
    accs = checkpoint.get_optimizer_state(dist, state.opt_state[1])
    auditor = StateAuditor(dist, every=1, bytes_per_audit=None)
    findings = {'clean': auditor.check_state(state)}
    gi = dist.plan.hot_groups[0]
    if rank == 1:
      with torch.no_grad():
        state.params['embedding'][f'hot_group_{gi}'][3, 0] += 1.0
    findings['diverged'] = auditor.check_state(state)
    np.savez(f'{out_dir}/hot{rank}.npz', losses=np.array(losses),
             **{f'o{i}': o.numpy() for i, o in enumerate(outs)},
             **{f'w{i}': w.numpy() for i, w in enumerate(weights)},
             **{f'a{i}': a['acc'].numpy() for i, a in enumerate(accs)})
    with open(f'{out_dir}/hot{rank}.json', 'w') as f:
      json.dump({'legs': legs, 'hot_group': gi, 'findings': {
          k: [[x.check, x.leaf, list(x.devices), list(x.rows)] for x in v]
          for k, v in findings.items()}}, f)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()
