"""One rank of the port's multi-rank forward (``run``, for
tests/test_torch_exchange.py), hybrid train step (``train``, for
tests/test_torch_train_ranks.py), model-parallel-input forward and
step (``mp``, for tests/test_torch_mp_input.py), dense autodiff step
(``dense``, for tests/test_torch_dense_ranks.py), ragged inputs
through all three (``ragged``, for tests/test_torch_ragged_dist.py;
``ragged_run`` is the world of one's and each rank's body there), a
hot-cache layer (``hot``, for tests/test_torch_hotcache_ranks.py, and
``hot_chunks``, its four-rank test of the chunked hot-gradient sum;
``hot_dense``, the dense autodiff trainer on a hot layer, for
tests/test_torch_hot_dense.py),
the chunked exchange (``overlap``, for
tests/test_torch_overlap_ranks.py), an int8-quantized layer
(``quant``, for tests/test_torch_quantized_ranks.py and, column-sliced,
tests/test_torch_wire_ranks.py), a wire-codec draw (``wire``, for
tests/test_torch_wire_ranks.py) or a cold-tier layer beside its fully
resident twin (``tier``, for tests/test_torch_coldtier_ranks.py) or
one segmented-dispatch profile (``devprof``, for
tests/test_torch_devprof.py) or the multi-rank serving front end
(``serve_ranks``, ``serve_fault`` and ``serve_py``, for
tests/test_torch_serving_ranks.py) or serving replicas on disjoint rank
sets (``serve_replicas`` and ``serve_replicas_fault``, for
tests/test_torch_serving_replicas.py) or the rendezvous sanitizer's fit
drills (``commsan_fit``, for tests/test_torch_commsan.py) or the facts
behind commlint's detection scope (``commlint_scope``, for
tests/test_torch_commlint.py): joins a gloo
world on the CPU, runs on its slice of the batch and saves what it got.
Imports nothing of JAX (spawned processes import only this)."""

import itertools
import json
import pickle
import time


def rank_main(target, rank, world_size, init_method, case_path, out_dir):
  """The body of every spawned rank (``torch_parity.spawn_ranks``): fd 1
  and fd 2 go to ``rank{rank}.log`` under ``out_dir`` (``os.dup2``, so
  the output of C++ lands there too), ``faulthandler`` is on, and
  ``target(rank, world_size, init_method, case_path, out_dir)`` runs.
  Once it has returned (every worker tears its process group down in a
  ``finally``), the streams are flushed and ``done{rank}`` is written;
  then the process ends with ``os._exit(0)``, which skips the
  interpreter's teardown (module and C++ static destructors), where a
  gloo rank could abort with ``terminate called without an active
  exception`` after its work was done.  A rank that raised never gets
  here: it exits non-zero without its marker."""
  import faulthandler
  import os
  import sys
  log = open(os.path.join(out_dir, f'rank{rank}.log'), 'w')
  os.dup2(log.fileno(), 1)
  os.dup2(log.fileno(), 2)
  faulthandler.enable(file=sys.stderr, all_threads=True)
  target(rank, world_size, init_method, case_path, out_dir)
  print('returned', flush=True)
  sys.stdout.flush()
  sys.stderr.flush()
  with open(os.path.join(out_dir, f'done{rank}'), 'w') as f:
    f.write('done\n')
  log.flush()
  os._exit(0)


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


def overlap(rank, world_size, init_method, case_path, out_dir):
  """One rank of the chunked exchange (``overlap_chunks``) and the
  per-group schedule (``fused_exchange=False``), for
  tests/test_torch_overlap_ranks.py.  For every arm of ``case['arms']``
  (hot sets on or off, chunk count, fused): the forward of its slice of
  the first batch, ``backward_to_mp`` under fixed cotangents (uncached),
  2 ``SparseAdagrad`` and 2 ``SparseAdam`` steps and (uncached) 2 dense
  SGD steps, each from the case's weights, and the legs of the
  forward's and the backward's ``LookupPlan``s; then the order of the
  calls of one 3-round forward, and the row-slice refusal's message."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.ops import lookup as lookup_ops
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import dist_embedding
  from distributed_embeddings_tpu_torch.parallel import grad
  from distributed_embeddings_tpu_torch.parallel import hotcache
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import sparse
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu')
  try:
    tables = [TableConfig(r, w, combiner=c) for r, w, c in case['tables']]
    hot_sets = {t: hotcache.HotSet(t, np.asarray(v))
                for t, v in case['hot'].items()}
    b = case['batch'] // world_size
    mine = lambda cats: [c[rank * b:(rank + 1) * b] for c in cats]
    labels = torch.tensor(case['labels'][rank * b:(rank + 1) * b])

    def layer(hot, chunks, fused):
      return dist_embedding.DistributedEmbedding(
          tables, mesh=m, input_table_map=case['input_table_map'],
          overlap_chunks=chunks, fused_exchange=fused,
          hot_cache=hot_sets if hot else None,
          **(case['hot_options'] if hot else {}))

    def head(dense_params, emb_outs, y):
      x = torch.cat(list(emb_outs), dim=1)
      return torch.mean((x @ dense_params['kernel'] - y)**2)

    def sparse_run(dist, emb_opt):
      dense_opt = optim.sgd(case['lr'])
      state = sparse.init_hybrid_train_state(
          dist, {'embedding': checkpoint.set_weights(dist, case['weights']),
                 'kernel': torch.tensor(case['kernel'])}, dense_opt, emb_opt)
      step = sparse.make_hybrid_train_step(dist, head, dense_opt, emb_opt)
      losses = []
      for cats in case['batches']:
        state, loss = step(state, mine(cats), labels)
        losses.append(float(loss))
      got = {f'w{i}': w.numpy() for i, w in enumerate(
          checkpoint.get_weights(dist, state.params['embedding']))}
      for i, s in enumerate(checkpoint.get_optimizer_state(
          dist, state.opt_state[1])):
        got.update({f's{i}_{k}': v.numpy() for k, v in s.items()})
      got['losses'] = np.array(losses)
      return got

    def dense_run(dist):
      def loss_fn(p, batch):
        cats, y = batch
        return head(p, dist.apply(p['embedding'], cats), y)

      opt = optim.sgd(case['lr'])
      state = grad.init_train_state(
          {'embedding': checkpoint.set_weights(dist, case['weights']),
           'kernel': torch.tensor(case['kernel'])}, opt)
      step = grad.make_train_step(loss_fn, opt, group=m.group)
      losses = []
      for cats in case['batches']:
        state, loss = step(state, (mine(cats), labels))
        losses.append(float(loss))
      got = {f'w{i}': w.numpy() for i, w in enumerate(
          checkpoint.get_weights(dist, state.params['embedding']))}
      got['losses'] = np.array(losses)
      return got

    legs = {}
    for hot, chunks, fused in case['arms']:
      tag = f'{int(hot)}_{chunks}_{int(fused)}'
      dist = layer(hot, chunks, fused)
      params = checkpoint.set_weights(dist, case['weights'])
      cats = mine(case['batches'][0])
      with torch.no_grad():
        outs, _, sig = dist.forward_with_residuals(params, cats)
      got = {f'o{i}': o.numpy() for i, o in enumerate(outs)}
      d_outs = [torch.as_tensor(d[rank * b:(rank + 1) * b])
                for d in case['d_outs']]
      if hot:
        gsubs, hot_grads = dist.backward_to_mp(d_outs, *sig, cats=cats)
        got.update({f'h{gi}': g.numpy() for gi, g in hot_grads.items()})
      else:
        gsubs = dist.backward_to_mp(d_outs, *sig)
      got.update({f'g{i}': g.numpy() for i, g in enumerate(gsubs)})
      legs[tag] = {p.path: [l.as_dict() for l in p.legs]
                   for p in dist._lookup_plans.values()}
      for name, opt in (('adagrad', sparse.SparseAdagrad(case['lr'])),
                        ('adam', sparse.SparseAdam(case['lr']))):
        got.update({f'{name}_{k}': v for k, v in sparse_run(
            layer(hot, chunks, fused), opt).items()})
      if not hot:
        got.update({f'dense_{k}': v
                    for k, v in dense_run(layer(hot, chunks, fused)).items()})
      np.savez(f'{out_dir}/overlap{rank}_{tag}.npz', **got)

    # the order of one 3-round forward's calls: each round's id
    # exchange is issued before the round before it is waited on and
    # looked up, and every collective of the loop is asynchronous
    events = []
    issue, wait = (dist_embedding.DistributedEmbedding._issue,
                   dist_embedding._Pending.wait)
    fused_lookup, a2a = (lookup_ops.fused_group_lookup,
                         torch_dist.all_to_all_single)

    def rec_issue(self, bufs, name, plan=None):
      events.append(f'issue {name}')
      return issue(self, bufs, name, plan)

    def rec_wait(self):
      events.append('wait')
      return wait(self)

    def rec_lookup(*a, **k):
      events.append('lookup')
      return fused_lookup(*a, **k)

    def rec_a2a(*a, async_op=False, **k):
      events.append(f'a2a async={async_op}')
      return a2a(*a, async_op=async_op, **k)

    dist = layer(False, 3, True)
    params = checkpoint.set_weights(dist, case['weights'])
    dist_embedding.DistributedEmbedding._issue = rec_issue
    dist_embedding._Pending.wait = rec_wait
    lookup_ops.fused_group_lookup = rec_lookup
    torch_dist.all_to_all_single = rec_a2a
    try:
      with torch.no_grad():
        dist.apply(params, mine(case['batches'][0]))
    finally:
      dist_embedding.DistributedEmbedding._issue = issue
      dist_embedding._Pending.wait = wait
      lookup_ops.fused_group_lookup = fused_lookup
      torch_dist.all_to_all_single = a2a

    refusal = None
    try:
      dist_embedding.DistributedEmbedding(
          tables, mesh=m, input_table_map=case['input_table_map'],
          overlap_chunks=3, **case['hot_options'])
    except ValueError as e:
      refusal = str(e)
    with open(f'{out_dir}/overlap{rank}.json', 'w') as f:
      json.dump({'legs': legs, 'events': events, 'refusal': refusal}, f)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def hot_chunks(rank, world_size, init_method, case_path, out_dir):
  """One rank of a hot-cache layer trained at ``overlap_chunks`` 1 and
  ``case['chunks']`` (for tests/test_torch_hotcache_ranks.py's
  four-rank test): for each, ``case['batches']`` hybrid ``SparseAdagrad``
  + ``optim.sgd`` steps from the case's weights; saves the hot buffers
  and their accumulators as the rank holds them, the gathered tables and
  accumulators, and the losses."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import sparse
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
    b = case['batch'] // world_size
    mine = lambda cats: [c[rank * b:(rank + 1) * b] for c in cats]
    labels = torch.tensor(case['labels'][rank * b:(rank + 1) * b])

    def head_loss(dense_params, emb_outs, y):
      x = torch.cat(list(emb_outs), dim=1)
      return torch.mean((x @ dense_params['kernel'] - y)**2)

    for chunks in (1, case['chunks']):
      dist = DistributedEmbedding(tables, mesh=m, dp_input=True,
                                  hot_cache=hot_sets, overlap_chunks=chunks,
                                  **case['options'])
      dense_opt = optim.sgd(case['lr'])
      emb_opt = sparse.SparseAdagrad(case['lr'])
      state = sparse.init_hybrid_train_state(
          dist, {'embedding': checkpoint.set_weights(dist, case['weights']),
                 'kernel': torch.tensor(case['kernel'])}, dense_opt, emb_opt)
      step = sparse.make_hybrid_train_step(dist, head_loss, dense_opt,
                                           emb_opt)
      losses = []
      for cats in case['batches']:
        state, loss = step(state, mine(cats), labels)
        losses.append(float(loss))
      emb, emb_state = state.params['embedding'], state.opt_state[1]
      got = {'losses': np.array(losses)}
      for gi in dist.plan.hot_groups:
        got[f'h{gi}'] = emb[f'hot_group_{gi}'].numpy()
        got[f'ha{gi}'] = emb_state[f'hot_group_{gi}']['acc'].numpy()
      for i, w in enumerate(checkpoint.get_weights(dist, emb)):
        got[f'w{i}'] = w.numpy()
      for i, s in enumerate(checkpoint.get_optimizer_state(dist, emb_state)):
        got[f'a{i}'] = s['acc'].numpy()
      np.savez(f'{out_dir}/hot_chunks{rank}_{chunks}.npz', **got)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def hot_dense(rank, world_size, init_method, case_path, out_dir):
  """One rank of the dense autodiff trainer on a hot-cache layer, for
  tests/test_torch_hot_dense.py: for each id set of ``case['id_sets']``
  and each ``overlap_chunks`` of ``case['chunks']``, the gradient of
  ``sum(outputs * cotangents)`` over its slice of the batch through
  ``apply`` (every ``group_*`` table as this rank holds it, every
  ``hot_group_*`` buffer) and the outputs; then ``case['steps']``
  ``grad.make_train_step`` steps from the case's weights for each
  optimizer of ``case['opts']`` (a linear head, the local-mean squared
  error), on a two-axis mesh where ``case['mesh_shape']`` names one (a
  ``dcn_sharding`` layer in ``case['options']`` trains beside its flat
  twin, which saves its final tables relocated to the hierarchical
  layout).  Saves all of it, with the gathered tables after the
  steps."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import grad
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding, hierarchical_params)
  from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu',
                                mesh_shape=case.get('mesh_shape'))
  try:
    tables = [TableConfig(r, w, combiner=c) for r, w, c in case['tables']]
    hot_sets = {t: HotSet(t, np.asarray(ids))
                for t, ids in case['hot'].items()}
    options = case.get('options', {})
    b = case['batch'] // world_size
    mine = lambda xs: [x[rank * b:(rank + 1) * b] for x in xs]
    got = {}
    for n, (cats, cots) in enumerate(case['id_sets']):
      for chunks in case['chunks']:
        dist = DistributedEmbedding(tables, mesh=m, dp_input=True,
                                    hot_cache=hot_sets,
                                    overlap_chunks=chunks)
        params = checkpoint.set_weights(dist, case['weights'])
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params.items()}
        outs = dist.apply(leaves, mine(cats))
        sum(torch.sum(o * torch.tensor(c))
            for o, c in zip(outs, mine(cots))).backward()
        for k, v in leaves.items():
          got[f'g{n}_{chunks}_{k}'] = v.grad.numpy()
        for i, o in enumerate(outs):
          got[f'o{n}_{chunks}_{i}'] = o.detach().numpy()
    cats = mine(case['step_cats'])
    labels = torch.tensor(case['labels'][rank * b:(rank + 1) * b])
    hier = options.get('dcn_sharding', False)

    def train(name, dist, emb):
      opt = getattr(optim, name)(case['lr'])

      def loss_fn(p, batch):
        x = torch.cat(dist.apply(p['embedding'], batch[0]), dim=1)
        return torch.mean((x @ p['kernel'] - batch[1])**2)

      state = grad.init_train_state(
          {'embedding': emb, 'kernel': torch.tensor(case['kernel'])}, opt)
      step = grad.make_train_step(loss_fn, opt, dist=dist)
      losses = []
      for _ in range(case['steps']):
        state, loss = step(state, (cats, labels))
        losses.append(float(loss))
      return state, np.array(losses)

    for name in case['opts']:
      # a dcn_sharding layer takes its weights from a flat twin
      # (hierarchical_params): the twin trains beside it, and its final
      # tables, relocated the same way, are what it must hold
      flat = DistributedEmbedding(tables, mesh=m, dp_input=True,
                                  hot_cache=hot_sets)
      flat_emb = checkpoint.set_weights(flat, case['weights'])
      if hier:
        dist = DistributedEmbedding(tables, mesh=m, dp_input=True,
                                    hot_cache=hot_sets, **options)
        # (the hot buffers pass through hierarchical_params as they are,
        # and a step updates them in place: the twin keeps its own)
        state, got[f'{name}_losses'] = train(name, dist, hierarchical_params(
            dist, {k: v.clone() for k, v in flat_emb.items()}))
        twin, got[f'{name}_twin_losses'] = train(name, flat, flat_emb)
        want = hierarchical_params(dist, twin.params['embedding'])
        for k, v in state.params['embedding'].items():
          got[f'{name}_hier_{k}'] = v.numpy()
          got[f'{name}_twin_{k}'] = want[k].numpy()
        got[f'{name}_kernel'] = state.params['kernel'].numpy()
        got[f'{name}_twin_kernel'] = twin.params['kernel'].numpy()
        continue
      state, got[f'{name}_losses'] = train(name, flat, flat_emb)
      emb = state.params['embedding']
      got[f'{name}_kernel'] = state.params['kernel'].numpy()
      for i, w in enumerate(checkpoint.get_weights(flat, emb)):
        got[f'{name}_w{i}'] = w.numpy()
      for gi in flat.plan.hot_groups:
        got[f'{name}_hot{gi}'] = emb[f'hot_group_{gi}'].numpy()
    np.savez(f'{out_dir}/hot_dense{rank}.npz', **got)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def commlint_scope(rank, world_size, init_method, case_path, out_dir):
  """One rank behind the port's ``commlint.DETECTION_SCOPE``, for
  tests/test_torch_commlint.py: the detections ``fit`` acts on reach
  every rank alike.  (1) Losses: the sparse step's and the dense step's
  loss over unequal local batches (each rank's local mean differs) as
  each rank returns it.  (2) ``audit_failure``: a tiered layer's
  ``'tier'`` audit before and after rank 1 alone corrupts one host-tier
  row.  (3) ``tier_integrity``: sparse steps of the tiered layer, rank 1
  alone corrupting one host-tier row that step ``case['corrupt_at']``
  fetches; the step at which ``TierIntegrityError`` reached this rank.
  Saves all of it as JSON."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import audit
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import coldtier
  from distributed_embeddings_tpu_torch.parallel import grad
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import sparse
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
    hot = {t: HotSet(t, np.asarray(v)) for t, v in case['hot'].items()}
    b = case['batch'] // world_size
    mine = lambda xs: [x[rank * b:(rank + 1) * b] for x in xs]
    labels = torch.tensor(case['labels'][rank * b:(rank + 1) * b])

    def head_loss(dense_params, emb_outs, y):
      x = torch.cat(list(emb_outs), dim=1)
      return torch.mean((x @ dense_params['kernel'] - y)**2)

    def layer(**kw):
      return DistributedEmbedding(tables, mesh=m, dp_input=True,
                                  hot_cache=dict(hot), **kw)

    def trainer(d):
      state = sparse.init_hybrid_train_state(
          d, {'embedding': checkpoint.set_weights(d, case['weights']),
              'kernel': torch.tensor(case['kernel'])}, optim.sgd(0.05),
          sparse.SparseSGD(0.05))
      return state, sparse.make_hybrid_train_step(
          d, head_loss, optim.sgd(0.05), sparse.SparseSGD(0.05))

    out = {'rank': rank}
    # (1) the losses fit reads
    state, step = trainer(layer())
    _, loss = step(state, mine(case['batches'][0]), labels)
    out['sparse_loss'] = float(loss)
    d = layer()
    opt = optim.sgd(0.05)

    def loss_fn(p, batch):
      return head_loss(p, d.apply(p['embedding'], batch[0]), batch[1])

    dstate = grad.init_train_state(
        {'embedding': checkpoint.set_weights(d, case['weights']),
         'kernel': torch.tensor(case['kernel'])}, opt)
    _, loss = grad.make_train_step(loss_fn, opt, dist=d)(
        dstate, (mine(case['batches'][0]), labels))
    out['dense_loss'] = float(loss)
    out['local_loss'] = float(loss_fn(
        {'embedding': checkpoint.set_weights(d, case['weights']),
         'kernel': torch.tensor(case['kernel'])},
        (mine(case['batches'][0]), labels)))

    # the tiered layer: a budget under its resident bytes
    probe = layer()
    budget = int(probe.plan.resident_table_bytes() * case['budget_frac'])
    t = layer(cold_tier=True, device_hbm_budget=budget)
    state, step = trainer(t)
    t.cold_tier.enable_digests()
    gi = t.plan.cold_tier_groups[0]

    def corrupt(row):
      t.cold_tier.payload[gi].view(np.uint8)[row, 1] ^= np.uint8(1 << 3)

    # (2) the tier audit, which gathers its findings
    aud = audit.StateAuditor(t, every=1, checks=('tier',),
                             bytes_per_audit=None)
    out['audit_clean'] = [[f.leaf, list(f.devices), list(f.rows)]
                          for f in aud.run()]
    if rank == 1:
      corrupt(2)
    out['audit_one_rank'] = [[f.leaf, list(f.devices), list(f.rows)]
                             for f in aud.run()]
    if rank == 1:
      corrupt(2)  # flip back

    # (3) the fetch-time integrity check
    out['raised_at'] = None
    out['corrupted'] = None
    for k, cats in enumerate(case['batches']):
      if k == case['corrupt_at']:
        rows, _ = coldtier.compute_fetch_rows(
            t, t._prepare_inputs(mine(cats))[0])
        if rank == 1:
          mine_rows = rows[gi] - t.plan.groups[gi].device_rows
          if mine_rows.size:
            out['corrupted'] = int(mine_rows[0])
            corrupt(out['corrupted'])
      try:
        state, _ = step(state, mine(cats), labels)
      except coldtier.TierIntegrityError as e:
        out['raised_at'] = k
        out['error'] = str(e)
        break
    with open(f'{out_dir}/scope{rank}.json', 'w') as f:
      json.dump(out, f)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def quant(rank, world_size, init_method, case_path, out_dir):
  """One rank of an int8-quantized layer (for
  tests/test_torch_quantized_ranks.py), uncached and cached, at each
  wire dtype of ``case['wires']`` (default ``None`` alone): the forward
  of its slice of the batch, then ``SparseAdagrad`` + ``optim.sgd``
  steps with a linear head; saves the outputs, the exported payload and
  scale pairs, the accumulators, the hot buffers and the losses.  With
  ``case['save']`` rank 0 also saves the uncached layer's tables as set
  (``save_train_npz``), before any step."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import quantization
  from distributed_embeddings_tpu_torch.parallel import sparse
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
    b = case['batch'] // world_size
    mine = lambda cats: [c[rank * b:(rank + 1) * b] for c in cats]
    labels = torch.tensor(case['labels'][rank * b:(rank + 1) * b])

    def head(dense_params, emb_outs, y):
      x = torch.cat(list(emb_outs), dim=1)
      return torch.mean((x @ dense_params['kernel'] - y)**2)

    for wire, hot in itertools.product(case.get('wires', (None,)),
                                       (False, True)):
      hot_sets = ({t: HotSet(t, np.asarray(ids))
                   for t, ids in case['hot'].items()} if hot else None)
      dist = DistributedEmbedding(tables, mesh=m, dp_input=True,
                                  table_dtype=case['dtype'],
                                  hot_cache=hot_sets, wire_dtype=wire,
                                  **case['options'])
      params = checkpoint.set_weights(dist, case['weights'])
      tag = f'{int(hot)}' + ('' if wire is None else f'_{wire}')
      if case.get('save') and not hot:
        weights = checkpoint.export_tables(dist, params)
        if rank == 0:
          checkpoint.save_train_npz(f'{out_dir}/quant_{tag}.ckpt.npz',
                                    weights, plan=dist)
      with torch.no_grad():
        outs = dist.apply(params, mine(case['cats']))
      dense_opt = optim.sgd(case['lr'])
      emb_opt = sparse.SparseAdagrad(case['lr'])
      state = sparse.init_hybrid_train_state(
          dist, {'embedding': params, 'kernel': torch.tensor(case['kernel'])},
          dense_opt, emb_opt)
      step = sparse.make_hybrid_train_step(dist, head, dense_opt, emb_opt)
      losses = []
      for cats in case['batches']:
        state, loss = step(state, mine(cats), labels)
        losses.append(float(loss))
      emb = state.params['embedding']
      got = {'losses': np.array(losses)}
      got.update({f'o{i}': o.numpy() for i, o in enumerate(outs)})
      for i, w in enumerate(checkpoint.export_tables(dist, emb)):
        got[f'p{i}'] = np.asarray(w.payload).view(np.uint8)
        got[f's{i}'] = w.scale
      for i, s in enumerate(checkpoint.get_optimizer_state(
          dist, state.opt_state[1])):
        got[f'a{i}'] = s['acc'].numpy()
      for k, v in emb.items():
        if k.startswith('hot_'):
          got[k] = quantization.bits(v).numpy()
      np.savez(f'{out_dir}/quant{rank}_{tag}.npz', **got)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def _leaves(prefix, tree, out):
  """The tensors of a nested dict as ``out[prefix/key/...]`` numpy arrays
  (a float8 tensor as its bits)."""
  from distributed_embeddings_tpu_torch.parallel import quantization
  for k, v in tree.items():
    if isinstance(v, dict):
      _leaves(f'{prefix}/{k}', v, out)
    else:
      out[f'{prefix}/{k}'] = quantization.bits(v).detach().numpy()
  return out


def wire(rank, world_size, init_method, case_path, out_dir):
  """One rank of a wire-codec draw (``wire_dtype``, for
  tests/test_torch_wire_ranks.py): the layer at ``case['wire']`` and its
  ``wire_dtype=None`` twin over the same weights.  For each: the forward
  of its slice of the batch; ``backward_to_mp`` under the case's
  cotangents, then the legs of its plans, their collective counts and
  ``planner.reconcile_exchange``; uncached, one ``SparseAdagrad(0.05)``
  apply of those gradients; then ``case['steps']`` hybrid steps
  (``case['opt']``, SGD on a linear head).  Saves what the rank holds
  (tables, scales, hot buffers, optimizer state) bit for bit, the
  exported tables, the gathered optimizer state and the losses.

  A ``case['dcn']`` draw runs on a 2 x ``world / 2`` ``(dcn, data)`` mesh
  with ``dcn_sharding=True``: the weights go into a flat twin and from
  there into the hierarchical layout (``hierarchical_params``), and only
  the rank's own leaves are saved (the checkpoint functions refuse the
  layout)."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import planner
  from distributed_embeddings_tpu_torch.parallel import sparse
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding, hierarchical_params)
  from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  dcn = case.get('dcn', False)
  m = mesh_lib.init_distributed(
      init_method, world_size, rank, backend='gloo', device='cpu',
      mesh_shape=(2, world_size // 2) if dcn else None)
  try:
    tables = [TableConfig(r, w, combiner=c) for r, w, c in case['tables']]
    hot_sets = (None if case['hot'] is None else
                {t: HotSet(t, np.asarray(v)) for t, v in case['hot'].items()})

    def build(wire_dtype, dcn_sharding=dcn):
      return DistributedEmbedding(
          tables, mesh=m, dp_input=True, hot_cache=hot_sets,
          overlap_chunks=case['chunks'], table_dtype=case['dtype'],
          wire_dtype=wire_dtype, dcn_sharding=dcn_sharding)

    def weights_of(dist):
      if not dcn:
        return checkpoint.set_weights(dist, case['weights'])
      return hierarchical_params(
          dist, checkpoint.set_weights(build(None, False), case['weights']))

    b = case['batch'] // world_size
    mine = lambda xs: [x[rank * b:(rank + 1) * b] for x in xs]
    cats = mine(case['ids'])
    labels = torch.tensor(case['labels'][rank * b:(rank + 1) * b])
    d_outs = [torch.as_tensor(d) for d in mine(case['d_outs'])]
    lr = case['lr']

    def head(dense_params, emb_outs, y):
      x = torch.cat(list(emb_outs), dim=-1)
      return torch.mean((x @ dense_params['kernel'] - y)**2)

    info = {}
    for tag, wire_dtype in (('off', None), ('on', case['wire'])):
      dist = build(wire_dtype)
      params = weights_of(dist)
      with torch.no_grad():
        got = {f'o{i}': o.numpy()
               for i, o in enumerate(dist.apply(params, cats))}
        _, residuals, routing, sig = dist.forward_with_residuals(
            params, cats, with_routing=True)
        if hot_sets:
          gsubs, hot_grads = dist.backward_to_mp(d_outs, *sig,
                                                 routing=routing)
          got.update({f'h{gi}': g.numpy() for gi, g in hot_grads.items()})
        else:
          gsubs = dist.backward_to_mp(d_outs, *sig)
      got.update({f'g{i}': g.numpy() for i, g in enumerate(gsubs)})
      plans = {p.path: p for p in dist._lookup_plans.values()}
      info[tag] = {
          'wire_dtype': dist.wire_dtype,
          'legs': {k: [l.as_dict() for l in p.legs]
                   for k, p in plans.items()},
          'collectives': {k: p.collective_count() for k, p in plans.items()},
          'reconcile': planner.reconcile_exchange(dist, journal=False)}
      if not hot_sets:
        iso = sparse.SparseAdagrad(0.05)
        iso_state = iso.init(dist, params)
        sparse.sparse_apply_updates(dist, iso, params, iso_state, residuals,
                                    list(gsubs), 0.05, *sig)
        _leaves('iso_p', params, got)
        _leaves('iso_s', iso_state, got)
      emb_opt = (sparse.SparseSGD(lr) if case['opt'] == 'sgd'
                 else sparse.SparseAdagrad(lr))
      dense_opt = optim.sgd(lr)
      state = sparse.init_hybrid_train_state(
          dist, {'embedding': weights_of(dist),
                 'kernel': torch.tensor(case['kernel'])}, dense_opt,
          emb_opt)
      step = sparse.make_hybrid_train_step(dist, head, dense_opt, emb_opt)
      losses = []
      for _ in range(case['steps']):
        state, loss = step(state, cats, labels)
        losses.append(float(loss))
      got['losses'] = np.array(losses)
      got['kernel'] = state.params['kernel'].numpy()
      _leaves('p', state.params['embedding'], got)
      _leaves('s', state.opt_state[1], got)
      if dcn:
        np.savez(f'{out_dir}/wire{rank}_{tag}.npz', **got)
        continue
      for i, w in enumerate(checkpoint.export_tables(
          dist, state.params['embedding'])):
        if case['dtype'] is None:
          got[f'w{i}'] = w
        else:
          got[f'w{i}_payload'] = np.asarray(w.payload).view(np.uint8)
          got[f'w{i}_scale'] = w.scale
      for i, s in enumerate(checkpoint.get_optimizer_state(
          dist, state.opt_state[1])):
        got.update({f'a{i}/{k}': v.numpy() for k, v in s.items()})
      np.savez(f'{out_dir}/wire{rank}_{tag}.npz', **got)
    with open(f'{out_dir}/wire{rank}.json', 'w') as f:
      json.dump(info, f)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()



def two_axis(rank, world_size, init_method, case_path, out_dir):
  """One rank of a 2 x 2 ``(dcn, data)`` gloo mesh for
  tests/test_torch_two_axis_mesh.py: each of ``case['scenarios']`` in
  turn on the two-axis layer (tables on the data axis, replicated across
  slices): the mesh's axes and each group's collectives (``shape``), a
  forward and a dense SGD step (``fwd_sgd``), a sparse hybrid step
  (``sparse``), the weights round trip and a checkpoint file
  (``ckpt``), ``init``, ``calibrate``, a ``ServingEngine`` (``serve``),
  the auditor's replica check over both axes (``audit``) and a dense
  step of a ``dcn_sharding`` layer beside its flat twin
  (``hier_dense``).  Saves ``two_axis{rank}.pkl``."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import audit
  from distributed_embeddings_tpu_torch.parallel import callbacks
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import grad
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import sparse
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding, hierarchical_params)
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
  from distributed_embeddings_tpu_torch.serving.engine import ServingEngine

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu',
                                mesh_shape=case['shape'])
  out = {}
  try:
    me = m.product_rank
    for name, sc in case['scenarios'].items():
      kind = sc['kind']
      tables = [TableConfig(r, w, combiner=c) for r, w, c in sc['tables']]
      gb = sc.get('batch', 16)
      b = gb // m.product_size
      mine = lambda xs: [x[me * b:(me + 1) * b] for x in xs]
      if kind == 'shape':
        probe = {}
        for axis, group, n in (('data', m.group, m.world_size),
                               ('dcn', m.dcn_group, m.num_slices),
                               ('product', m.product_group, m.product_size)):
          x = torch.full((n, 2), float(me))
          got = torch.empty_like(x)
          torch_dist.all_to_all_single(got, x, group=group)
          parts = [torch.empty(1) for _ in range(n)]
          torch_dist.all_gather(parts, torch.tensor([float(me)]),
                                group=group)
          s = torch.tensor([float(me)])
          torch_dist.all_reduce(s, group=group)
          probe[axis] = (got[:, 0].tolist(), [p.item() for p in parts],
                         s.item())
        d = DistributedEmbedding(tables, mesh=m)
        out[name] = {
            'axis_names': m.axis_names, 'world_size': d.world_size,
            'num_slices': d.num_slices, 'dcn_axis': d.dcn_axis,
            'slice': m.slice_index, 'rank': m.rank, 'product_rank': me,
            'links': mesh_lib.mesh_link_info(m),
            'batch': mesh_lib.batch_sharding(m, 16), 'probe': probe}
        continue
      if kind == 'serve':
        engine = ServingEngine(tables, sc['weights'], batch_size=gb,
                               mesh=m, device='cpu',
                               hotness=[x.shape[1] for x in sc['inputs']])
        out[name] = {'buckets': engine.buckets, 'outs': [
            o.numpy() for o in engine.lookup_padded(
                [x[:sc['n']] for x in sc['inputs']])]}
        continue
      if kind == 'hier_dense':
        # the dense trainer through the hierarchical exchange (its DCN
        # pair is differentiable) beside the flat twin's replicated sum
        res = {}
        for tag, dcn in (('flat', False), ('hier', True)):
          d = DistributedEmbedding(tables, mesh=m, dcn_sharding=dcn)
          flat_d = d if not dcn else DistributedEmbedding(tables, mesh=m)
          p = checkpoint.set_weights(flat_d, sc['weights'])
          if dcn:
            p = hierarchical_params(d, p)

          def loss_fn(prm, batch, d=d):
            return sum((o**2).sum() for o in d.apply(prm['embedding'],
                                                     batch)) / b

          opt = optim.sgd(sc['lr'])
          step = grad.make_train_step(loss_fn, opt, dist=d)
          state, loss = step(grad.init_train_state({'embedding': p}, opt),
                             mine(sc['inputs']))
          trained = state.params['embedding']
          if not dcn:
            trained = hierarchical_params(
                DistributedEmbedding(tables, mesh=m, dcn_sharding=True),
                trained)
          res[tag] = {'loss': float(loss),
                      'tables': {k: v.numpy() for k, v in trained.items()}}
        out[name] = res
        continue
      dist = DistributedEmbedding(tables, mesh=m, **sc.get('options', {}))
      if kind == 'audit':
        params = checkpoint.set_weights(dist, sc['weights'])
        state = sparse.init_hybrid_train_state(
            dist, {'embedding': params,
                   'kernel': torch.arange(6.0).reshape(3, 2)},
            optim.adagrad(0.1), sparse.SparseAdagrad(0.1))
        aud = audit.StateAuditor(dist, every=1)
        clean = aud.check_state(state)
        if me == 3:
          with torch.no_grad():
            state.params['kernel'][1, 0] += 1.0
        found = aud.check_state(state)
        out[name] = {'clean': [f.check for f in clean], 'found': [
            (f.check, f.leaf, f.devices, f.rows) for f in found]}
        continue
      if kind == 'init':
        out[name] = {k: v.numpy() for k, v in dist.init(3).items()}
        continue
      if kind == 'calibrate':
        out[name] = sparse.calibrate_capacity_rows(dist, mine(sc['cats']),
                                                   margin=1.0)
        continue
      params = checkpoint.set_weights(dist, sc['weights'])
      if kind == 'ckpt':
        back = [w.numpy() for w in checkpoint.get_weights(dist, params)]
        emb_opt = sparse.SparseAdagrad(0.1)
        state = sparse.init_hybrid_train_state(
            dist, {'embedding': params, 'kernel': torch.zeros(3, 1)},
            optim.adagrad(0.1), emb_opt)
        callbacks.CheckpointCallback(dist, sc['path'], every=1)(
            4, state._replace(step=4), {})
        out[name] = {'weights': back}
        continue
      if kind == 'fwd_sgd':
        flat = [i for dev in dist.plan.input_ids_list for i in dev]
        cats = (mine(sc['inputs']) if sc['options'].get('dp_input', True)
                else [sc['inputs'][i] for i in flat])
        with torch.no_grad():
          outs = [o.numpy() for o in dist.apply(params, cats)]

        def loss_fn(p, batch):
          return sum((o**2).sum() for o in dist.apply(p['embedding'],
                                                       batch)) / b

        opt = optim.sgd(sc['lr'])
        step = grad.make_train_step(loss_fn, opt, dist=dist)
        state, loss = step(grad.init_train_state({'embedding': params},
                                                 opt), cats)
        out[name] = {'outs': outs, 'loss': float(loss), 'weights': [
            w.numpy() for w in checkpoint.get_weights(
                dist, state.params['embedding'])]}
        continue
      assert kind == 'sparse', kind
      opt = (sparse.SparseSGD(sc['lr']) if sc['opt'] == 'sgd' else
             sparse.SparseAdagrad(sc['lr'], initial_accumulator_value=0.1,
                                  dedup=sc['opt'] == 'adagrad_dedup'))

      def head(dense_params, emb_outs, y):
        h = torch.cat(list(emb_outs), dim=-1)
        return torch.mean((h @ dense_params['kernel'] - y)**2)

      state = sparse.init_hybrid_train_state(
          dist, {'embedding': params, 'kernel': torch.tensor(sc['kernel'])},
          optim.sgd(sc['lr']), opt)
      step = sparse.make_hybrid_train_step(dist, head, optim.sgd(sc['lr']),
                                           opt)
      state, loss = step(state, mine(sc['inputs']),
                         torch.tensor(sc['labels'][me * b:(me + 1) * b]))
      out[name] = {'loss': float(loss), 'row_sliced': any(
          dist.plan.row_sliced), 'weights': [
              w.numpy() for w in checkpoint.get_weights(
                  dist, state.params['embedding'])]}
    with open(f'{out_dir}/two_axis{rank}.pkl', 'wb') as f:
      pickle.dump(out, f)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def hier(rank, world_size, init_method, case_path, out_dir):
  """One rank of a 2 x 2 ``(dcn, data)`` gloo mesh for
  tests/test_torch_hier_exchange.py: per draw of ``case['draws']``, a
  ``dcn_sharding=True`` layer beside its two-axis flat twin.  Checks
  that the hierarchical init is the flat init resharded, then takes the
  draw's weights into the twin (``checkpoint.set_weights``) and from
  there into the hierarchical layout (``hierarchical_params``); runs the
  forward of its block of the batch through both, two hybrid steps of
  each (``case['opt']``, a linear loss), and the exchange program with
  and without its DCN leg.  Saves ``hier{rank}.pkl``: the outputs, the
  losses, this cell's hierarchical leaves as converted, as trained and
  the trained twin's resharded, the forward's legs and the program
  totals."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import overlap
  from distributed_embeddings_tpu_torch.parallel import sparse
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding, hierarchical_params)
  from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu',
                                mesh_shape=case['shape'])
  out = {}
  try:
    me = m.product_rank
    for name, dr in case['draws'].items():
      tables = [TableConfig(r, w, combiner=c) for r, w, c in dr['tables']]
      kw = dict(dr['options'])
      if dr['hot'] is not None:
        kw['hot_cache'] = {t: HotSet(t, np.asarray(v))
                           for t, v in dr['hot'].items()}
      flat = DistributedEmbedding(tables, mesh=m, **kw)
      hl = DistributedEmbedding(tables, mesh=m, dcn_sharding=True, **kw)
      b = dr['batch'] // m.product_size
      mine = lambda xs: [x[me * b:(me + 1) * b] for x in xs]
      real = {gi: g.rows_h[m.slice_index][m.rank]
              for gi, g in enumerate(hl.hier.groups)}

      def cell(params):
        # this cell's real rows of each leaf (padding past them is filler)
        leaves = {}
        for k, v in params.items():
          v = v.detach()
          if not k.startswith('hot_'):
            v = v[:real[int(k.rsplit('_', 1)[1])]]
          leaves[k] = _leaves('x', {'v': v}, {})['x/v']
        return leaves

      # the hierarchical init IS the flat init resharded
      drawn, resharded = (cell(hl.init(dr['seed'])),
                          cell(hierarchical_params(hl, flat.init(dr['seed']))))
      assert sorted(drawn) == sorted(resharded)
      for k in drawn:
        np.testing.assert_array_equal(drawn[k], resharded[k], err_msg=k)
      pf = checkpoint.set_weights(flat, dr['weights'])
      ph = hierarchical_params(hl, pf)
      res = {'converted': cell(ph)}
      with torch.no_grad():
        res['flat_outs'] = [o.numpy() for o in flat.apply(pf, mine(dr['ins']))]
        res['outs'] = [o.numpy() for o in hl.apply(ph, mine(dr['ins']))]
      res['legs'] = [l.as_dict() for l in hl.lookup_plan().legs]
      res['flat_legs'] = [l.as_dict() for l in flat.lookup_plan().legs]
      opt = (sparse.SparseSGD(0.3) if dr['opt'] == 'sgd'
             else sparse.SparseAdagrad(0.3))
      W = [torch.tensor(w) for w in dr['W']]

      def loss_fn(dense_params, emb_outs, batch):
        return sum((o * w).sum() for o, w in zip(emb_outs, W)) / b

      trained = {}
      for tag, dist, p in (('flat', flat, pf), ('hier', hl, ph)):
        state = sparse.init_hybrid_train_state(
            dist, {'embedding': {k: v.clone() for k, v in p.items()}},
            optim.sgd(0.1), opt)
        step = sparse.make_hybrid_train_step(dist, loss_fn, optim.sgd(0.1),
                                             opt)
        losses = []
        for ins in dr['steps']:
          state, loss = step(state, mine(ins), None)
          losses.append(float(loss))
        res[f'{tag}_losses'] = losses
        trained[tag] = state
      res['trained'] = cell(trained['hier'].params['embedding'])
      res['trained_flat'] = cell(hierarchical_params(
          hl, trained['flat'].params['embedding']))
      res['state'] = {}
      for k, st in trained['hier'].opt_state[1].items():
        for leaf, v in st.items():
          if not k.startswith('hot_'):
            v = v[:real[int(k.rsplit('_', 1)[1])]]
          res['state'][f'{k}/{leaf}'] = v.numpy()
      totals = {}
      for tag, dist, leg in (('hier', hl, True), ('ici_only', hl, False),
                             ('flat', flat, True)):
        fn, inputs = overlap.build_exchange_program(dist, mine(dr['ins']),
                                                    dcn_leg=leg)
        totals[tag] = float(fn(*inputs))
      res['program'] = totals
      out[name] = res
    with open(f'{out_dir}/hier{rank}.pkl', 'wb') as f:
      pickle.dump(out, f)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def tier(rank, world_size, init_method, case_path, out_dir):
  """One rank of a cold-tier layer and its fully resident twin (for
  tests/test_torch_coldtier_ranks.py), per ``case['variants']`` entry
  ``(table_dtype, optimizer)``: both layers' forward of its slice of
  ``case['cats']``, its fetch rows and every rank's counts of that batch
  (``coldtier.compute_fetch_rows``) and ``fetch_stats``, then
  ``case['steps']`` hybrid steps of each (a linear head, ``optim.sgd``)
  and the gathered tables, optimizer state and losses.  The first
  variant also trains a third layer through ``ColdFetchPipeline`` (saved
  beside its stats); a fourth closes a pipeline after one of three
  epochs' batches (its worker must end) and then trains through another
  with the row digests on and a default ``StateAuditor`` run after each
  step (the worker's all-gathers beside the fetch-time digest checks and
  the audit's sweeps); and its tiered layer's ``'tier'`` audit runs once
  healthy and once after rank ``world_size - 1`` flips a byte of its
  first tail row."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.parallel import audit
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import coldtier
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import sparse
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
    b = case['batch'] // world_size
    mine = lambda cats: [c[rank * b:(rank + 1) * b] for c in cats]
    labels = torch.tensor(case['labels'][rank * b:(rank + 1) * b])
    hot_sets = lambda: {t: HotSet(t, np.asarray(ids))
                        for t, ids in case['hot'].items()}

    def head(dense_params, emb_outs, y):
      x = torch.cat(list(emb_outs), dim=1)
      return torch.mean((x @ dense_params['kernel'] - y)**2)

    def train(dist, opt_name, pipelined=False, audited=False):
      emb_opt = (sparse.SparseSGD(case['lr']) if opt_name == 'sgd'
                 else sparse.SparseAdagrad(case['lr']))
      dense_opt = optim.sgd(case['lr'])
      state = sparse.init_hybrid_train_state(
          dist, {'embedding': checkpoint.set_weights(dist, case['weights']),
                 'kernel': torch.tensor(case['kernel'])},
          dense_opt, emb_opt)
      step = sparse.make_hybrid_train_step(dist, head, dense_opt, emb_opt)
      # the default checks ('tier' among them) arm the row digests
      auditor = audit.StateAuditor(dist, every=1) if audited else None
      losses, stats, findings = [], None, []
      if pipelined:
        pipe = coldtier.ColdFetchPipeline(
            dist, (mine(c) for c in case['batches']))
        for i, (cats, fetch) in enumerate(pipe):
          state, loss = step(state, cats, labels, cold_fetch=fetch)
          losses.append(float(loss))
          if auditor is not None:
            findings += [f.brief() for f in auditor.check_state(
                state, step=i + 1)]
        stats = pipe.stats()
        pipe.close()
      else:
        for cats in case['batches']:
          state, loss = step(state, mine(cats), labels)
          losses.append(float(loss))
      got = {'losses': np.array(losses)}
      if auditor is not None:
        got['findings'] = np.array(json.dumps(
            {'audits': auditor.audits, 'digests':
             dist.cold_tier.digests_enabled, 'findings': findings}))
      for i, w in enumerate(checkpoint.export_tables(
          dist, state.params['embedding'])):
        if hasattr(w, 'payload'):
          got[f'p{i}'] = np.asarray(w.payload).view(np.uint8)
          got[f's{i}'] = np.asarray(w.scale)
        else:
          got[f'w{i}'] = np.asarray(w)
      for i, st in enumerate(checkpoint.get_optimizer_state(
          dist, state.opt_state[1])):
        for k, v in st.items():
          got[f'{k}{i}'] = v.numpy()
      return got, stats

    for vi, (dtype, opt_name) in enumerate(case['variants']):
      twin = DistributedEmbedding(tables, mesh=m, dp_input=True,
                                  table_dtype=dtype, hot_cache=hot_sets())
      tiered = lambda: DistributedEmbedding(
          tables, mesh=m, dp_input=True, table_dtype=dtype,
          hot_cache=hot_sets(), cold_tier=True,
          device_hbm_budget=case['budgets'][vi])
      dist = tiered()
      got = {}
      with torch.no_grad():
        for tag, d in (('t', dist), ('u', twin)):
          outs = d.apply(checkpoint.set_weights(d, case['weights']),
                         mine(case['cats']))
          got.update({f'o{tag}{i}': o.numpy() for i, o in enumerate(outs)})
      inputs, _, _ = dist._prepare_inputs(mine(case['cats']))
      rows, counts = coldtier.compute_fetch_rows(dist, inputs)
      for gi in dist.plan.cold_tier_groups:
        got[f'rows{gi}'] = rows[gi]
        got[f'counts{gi}'] = np.array(counts[gi])
      fetch = dist.build_cold_fetch(mine(case['cats']))
      got['fetch_stats'] = np.array(json.dumps(coldtier.fetch_stats(
          dist, fetch)))
      for tag, d in (('t', dist), ('u', twin)):
        res, _ = train(d, opt_name)
        got.update({f'{tag}_{k}': v for k, v in res.items()})
      if vi == 0:
        res, stats = train(tiered(), opt_name, pipelined=True)
        got.update({f'pipe_{k}': v for k, v in res.items()})
        got['pipe_stats'] = np.array(json.dumps(stats))
        d2 = tiered()

        def late_on_rank0(batches):
          # rank 0's worker reaches batch 2 only after its consumer has
          # closed, while the other ranks' workers already all-gather it
          for k, c in enumerate(batches):
            if k == 2 and rank == 0:
              time.sleep(0.5)
            yield mine(c)

        early = coldtier.ColdFetchPipeline(d2,
                                           late_on_rank0(case['batches'] * 3))
        next(early)
        if rank:
          time.sleep(0.2)
        early.close(join_timeout=10.0)
        got['early_alive'] = np.array(early._thread.is_alive())
        res, _ = train(d2, opt_name, pipelined=True, audited=True)
        got.update({f'apipe_{k}': v for k, v in res.items()})
        auditor = audit.StateAuditor(dist, every=1, checks=('tier',),
                                     bytes_per_audit=None)
        got['audit_healthy'] = np.array(len(auditor.run()))
        gi = dist.plan.cold_tier_groups[0]
        if rank == world_size - 1:
          dist.cold_tier.payload[gi].view(np.uint8)[0, 0] ^= 1
        found = auditor.run()
        got['audit_found'] = np.array(json.dumps(
            [[f.check, f.leaf, list(f.devices), list(f.rows)]
             for f in found]))
      np.savez(f'{out_dir}/tier{rank}_{vi}.npz', **got)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def devprof(rank, world_size, init_method, case_path, out_dir):
  """One rank of tests/test_torch_devprof.py: with obs armed, one
  ``devprof.profile_step`` of a ``dp_input`` layer on this rank's block
  of the batch (on a two-axis ``case['shape']`` mesh a
  ``dcn_sharding=True`` layer); saves its trace as ``trace{rank}.json``
  and ``devprof{rank}.pkl``: the profile, its device phases, the
  journaled event, the metrics and whether the caller's params were
  left as they were."""
  import dataclasses

  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import obs
  from distributed_embeddings_tpu_torch.obs import devprof as devprof_lib
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding)
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
  from distributed_embeddings_tpu_torch.utils import resilience

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu',
                                mesh_shape=case['shape'])
  try:
    tables = [TableConfig(r, w, combiner=c) for r, w, c in case['tables']]
    dist = DistributedEmbedding(tables, mesh=m, dp_input=True,
                                dcn_sharding=case['shape'] is not None)
    params = dist.init(case['seed'])
    before = {k: v.clone() for k, v in params.items()}
    b = case['batch'] // m.product_size
    me = m.product_rank
    mine = [c[me * b:(me + 1) * b] for c in case['cats']]
    obs.enable()
    resilience.clear_recent()
    prof = devprof_lib.profile_step(dist, mine, params=params, reps=2)
    out = dataclasses.asdict(prof)
    out['device_phases'] = devprof_lib.device_phases(prof)
    out['journal'] = resilience.recent('devprof_profile')
    out['metrics'] = obs.metrics.snapshot()
    out['untouched'] = all(torch.equal(before[k], params[k])
                           for k in params)
    obs.trace.save(f'{out_dir}/trace{rank}.json')
    with open(f'{out_dir}/devprof{rank}.pkl', 'wb') as f:
      pickle.dump(out, f)
    torch_dist.barrier()
  finally:
    obs.reset()
    torch_dist.destroy_process_group()


def _serve_engine(case, mesh, buckets=None):
  """The serving engine of tests/test_torch_serving_ranks.py's case on
  ``mesh`` (``buckets``: its ladder, default the engine's; with a
  ``cold_budget`` in the case, a cold tier under that budget)."""
  import numpy as np

  from distributed_embeddings_tpu_torch import serving
  from distributed_embeddings_tpu_torch.parallel.hotcache import HotSet
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  return serving.ServingEngine(
      [TableConfig(r, w, combiner=c) for r, w, c in case['tables']],
      case['weights'], batch_size=case['batch'], mesh=mesh, device='cpu',
      buckets=buckets, input_table_map=case['itm'], hotness=case['hotness'],
      cold_tier=case.get('cold_budget') is not None,
      device_hbm_budget=case.get('cold_budget'),
      hot_sets={t: HotSet(t, np.asarray(i)) for t, i in case['hot'].items()})


def _refusal(fn):
  """``'<type>: <message>'`` of what ``fn()`` raised, or None."""
  try:
    fn()
  except Exception as e:  # recorded, checked by the parent
    return f'{type(e).__name__}: {e}'
  return None


def serve_ranks(rank, world_size, init_method, case_path, out_dir):
  """One rank of tests/test_torch_serving_ranks.py: two engines (the
  replicas) behind one ``RankFrontEnd``.  The leader warms up through it,
  answers every request through ``lookup_padded``, four batchers
  (pipelined or serial, ladder or monolithic) and a two-replica pool
  (replica 0 failed half-way, then three low requests submitted while
  the link is held, so the pool degrades), a pool over the front end
  beside a world-of-one engine on its own card, checks the refusals, the
  empty request and a malformed one (no broadcast), and closes twice;
  every other rank serves.  On four ranks two replicas on disjoint
  halves of the world (a link each) first serve one request apiece.  The leader's control-group timeout is the
  case's ``idle_timeout``, and it idles past it before it closes: a
  follower's wait is not bound by it.  Saves ``serve{rank}.npz`` (the
  leader's answers) and ``serve{rank}.json`` (counts, stats,
  refusals)."""
  import time

  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import serving
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.serving import frontend
  from distributed_embeddings_tpu_torch.serving.batcher import host_outputs

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu')
  frontend.LEADER_TIMEOUT_S = case['idle_timeout']
  reqs = case['requests']
  out = {'rank': rank}
  got = {}
  try:
    eng, eng2 = _serve_engine(case, m), _serve_engine(case, m)
    out['refused_bare'] = [
        _refusal(lambda: serving.DynamicBatcher(eng)),
        _refusal(lambda: serving.ServingEnginePool([eng]))]
    if world_size == 4:
      # engines on half the world each: replicas on disjoint rank sets,
      # a link each, serve one request apiece before the world's
      layout = [[0, 1], [2, 3]]
      halves = [mesh_lib.create_mesh('cpu', ranks=r) for r in layout]
      ends = serving.replica_front_ends(
          [_serve_engine(case, h) if h is not None else None
           for h in halves], layout)
      if rank == 0:
        for i, end in enumerate(ends):
          for k, a in enumerate(host_outputs(end.lookup_padded(reqs[2]))):
            got[f'disjoint_{i}_{k}'] = a
          end.close()
        out['disjoint_links'] = [end.stats()['front_end'] for end in ends]
      else:
        out['disjoint_counts'] = ends[rank // 2].serve_forever()
    fe = serving.RankFrontEnd(eng)
    fe2 = fe.replica(eng2)
    if rank != 0:
      out['refused_follower'] = [
          _refusal(lambda: serving.DynamicBatcher(fe)),
          _refusal(lambda: serving.ServingEnginePool([fe, fe2])),
          _refusal(lambda: fe.lookup_padded(reqs[1]))]
      out['counts'] = fe.serve_forever()
      out['served'] = [e.stats()['batches_served'] for e in (eng, eng2)]
    else:
      fe.warmup()
      out['warm_batches'] = fe.stats()['front_end']['batches']
      for j, r in enumerate(reqs):
        for i, a in enumerate(host_outputs(fe.lookup_padded(r))):
          got[f'lone_{j}_{i}'] = a
      for arm, kw in (('pipe_ladder', {}),
                      ('serial_ladder', dict(pipeline=False)),
                      ('serial_mono', dict(pipeline=False,
                                           bucket_ladder=False)),
                      ('pipe_mono', dict(bucket_ladder=False))):
        bat = serving.DynamicBatcher(fe, max_delay_ms=5.0, **kw)
        try:
          futs = [bat.submit(r) for r in reqs]
          for j, fut in enumerate(futs):
            for i, a in enumerate(fut.result(timeout=120.0)):
              got[f'{arm}_{j}_{i}'] = a
          out[f'{arm}_stats'] = bat.stats()
        finally:
          bat.close()
      before = fe.stats()['front_end']['batches']
      wide = [np.asarray(c) for c in reqs[2]]
      k = case['hotness'].index(1)
      wide[k] = np.stack([wide[k], wide[k]], axis=1)
      out['refused_wide'] = _refusal(lambda: fe.lookup_padded(wide))
      out['empty_shapes'] = [list(o.shape) for o in fe.lookup_padded(
          [np.asarray(c)[:0] for c in reqs[1]])]
      out['sent_for_refused_and_empty'] = (
          fe.stats()['front_end']['batches'] - before)
      local = serving.ServingEngine(
          [c for c in eng.dist.table_configs], case['weights'],
          batch_size=case['batch'], device='cpu',
          mesh=mesh_lib.Mesh(torch.device('cpu')),
          input_table_map=case['itm'], hotness=case['hotness'])
      # the front end beside a world-of-one engine on this rank's card:
      # one pool over two links' worth of replicas, both serving
      mixed = serving.ServingEnginePool([fe, local], max_delay_ms=2.0)
      try:
        futs = [mixed.submit(r) for r in reqs]
        for j, fut in enumerate(futs):
          for i, a in enumerate(fut.result(timeout=120.0)):
            got[f'mixed_{j}_{i}'] = a
        out['mixed_served'] = [b.stats()['completed']
                               for b in mixed.batchers]
      finally:
        mixed.close()
      pool = serving.ServingEnginePool(
          [fe, fe2], max_delay_ms=2.0, queue_depth=64,
          degrade_high_watermark=2, degrade_low_watermark=1,
          degrade_patience=1)
      try:
        half = len(reqs) // 2
        for j, r in enumerate(reqs):
          if j == half:
            pool.fail_replica(0)
          for i, a in enumerate(pool.submit(r).result(timeout=120.0)):
            got[f'pool_{j}_{i}'] = a
        # the link held: no batch completes, so the pressure builds and
        # the second and third low requests are served degraded
        with fe.link.lock:
          futs = [pool.submit(r, priority='low') for r in case['degraded']]
        for j, fut in enumerate(futs):
          for i, a in enumerate(fut.result(timeout=120.0)):
            got[f'degraded_{j}_{i}'] = a
        out['pool_stats'] = pool.stats()
      finally:
        pool.close()
      # idle past the leader's timeout: the followers wait on
      t0 = time.monotonic()
      time.sleep(case['idle_timeout'] + 1.0)
      out['idle_s'] = time.monotonic() - t0
      out['front_end'] = fe.stats()['front_end']
      out['served'] = [e.stats()['batches_served'] for e in (eng, eng2)]
      fe.close()
      fe.close()
      out['refused_closed'] = _refusal(lambda: fe.lookup_padded(reqs[1]))
      np.savez(f'{out_dir}/serve{rank}.npz', **got)
    with open(f'{out_dir}/serve{rank}.json', 'w') as f:
      json.dump(out, f, default=str)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def _replica_ends(case, rank):
  """Every process's part of tests/test_torch_serving_replicas.py's pool:
  a mesh over each replica's ranks of ``case['layout']`` (every process
  creates every mesh, in one order), this rank's engine on its own, and
  ``replica_front_ends``.  Returns the ends by replica and this rank's
  engine."""
  from distributed_embeddings_tpu_torch import serving
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib

  meshes = [mesh_lib.create_mesh('cpu', ranks=r) for r in case['layout']]
  engines = [_serve_engine(case, m, case['buckets']) if m is not None
             else None for m in meshes]
  mine = next(e for e in engines if e is not None)
  return serving.replica_front_ends(engines, case['layout']), mine


def _follow(ends, engine):
  """A follower's part: serve its replica's link until ``stop``; returns
  its counts and its engine's lookups."""
  from distributed_embeddings_tpu_torch import serving

  end = next(e for e in ends if isinstance(e, serving.RankFrontEnd))
  counts = end.serve_forever()
  return {'counts': counts, 'replica': ends.index(end),
          'engine_batches': engine.stats()['batches_served']}


def serve_replicas(rank, world_size, init_method, case_path, out_dir):
  """One rank of tests/test_torch_serving_replicas.py's parity case:
  replicas on the disjoint rank sets of ``case['layout']`` behind one
  pool on rank 0, the front door.  The front door warms every replica,
  answers every request through each replica alone (``lookup_padded``)
  and through a batcher on each, then through a pool over all of them,
  then the overload arm (``measure_overload``, replica 0 quarantined
  half-way; every pool request recorded), then the drill: a pool over
  the last replica alone, whose ``fail_replica(0)`` closes its link, so
  its followers return their counts.  Every other rank serves its link.
  Saves ``replicas{rank}.npz`` (the front door's answers) and
  ``replicas{rank}.json``."""
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import serving
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.serving import pool as pool_mod
  from distributed_embeddings_tpu_torch.serving.batcher import host_outputs

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  mesh_lib.init_distributed(init_method, world_size, rank, backend='gloo',
                            device='cpu')
  reqs = case['requests']
  out = {'rank': rank}
  try:
    ends, engine = _replica_ends(case, rank)
    if rank != 0:
      out.update(_follow(ends, engine))
    else:
      got = {}
      # refused before any group is made: ranks outside the world,
      # replicas that share a rank, a front end without an engine
      out['refused'] = [
          _refusal(lambda: mesh_lib.create_mesh('cpu', ranks=[0, 99])),
          _refusal(lambda: serving.replica_front_ends(
              [None, None], [[1, 2], [2, 0]])),
          _refusal(lambda: serving.RankFrontEnd(None))]
      out['cold_groups'] = list(engine.dist.plan.cold_tier_groups)
      if out['cold_groups']:
        # the mesh's host groups went to this rank's engine's cold tier
        out['refused'].append(
            _refusal(lambda: _serve_engine(case, engine.dist.mesh)))
      for e in ends:
        e.warmup()
      for i, e in enumerate(ends):
        for j, r in enumerate(reqs):
          for k, a in enumerate(host_outputs(e.lookup_padded(r))):
            got[f'lone{i}_{j}_{k}'] = a
        bat = serving.DynamicBatcher(e, max_delay_ms=5.0)
        try:
          for j, fut in enumerate([bat.submit(r) for r in reqs]):
            for k, a in enumerate(fut.result(timeout=120.0)):
              got[f'batch{i}_{j}_{k}'] = a
        finally:
          bat.close()
      pool = serving.ServingEnginePool(ends, max_delay_ms=2.0,
                                       queue_depth=64)
      try:
        futs = [pool.submit(r) for r in reqs]
        for j, fut in enumerate(futs):
          for k, a in enumerate(fut.result(timeout=120.0)):
            got[f'pool_{j}_{k}'] = a
        out['pool_stats'] = pool.stats()
      finally:
        pool.close()
      recorded = []
      req_init = pool_mod._PoolReq.__init__

      def record(self, *args, **kwargs):
        req_init(self, *args, **kwargs)
        recorded.append(self)

      pool_mod._PoolReq.__init__ = record
      try:
        over = case['overload']
        out['overload'] = serving.measure_overload(
            ends, over, max_delay_ms=2.0, deadline_ms=60000.0,
            queue_depth=64, degrade_high_watermark=10**6,
            failover_after=len(over) // 2)
      finally:
        pool_mod._PoolReq.__init__ = req_init
      outcomes = []
      for j, req in enumerate(recorded):
        err = req.future.error() if req.future.done() else 'unresolved'
        outcomes.append(None if err is None else type(err).__name__
                        if not isinstance(err, str) else err)
        if err is None:
          for k, a in enumerate(req.future.result(timeout=0)):
            got[f'over_{j}_{k}'] = a
      out['over_outcomes'] = outcomes
      out['over_retried'] = [req.retries for req in recorded]
      out['over_links'] = [
          e.stats()['front_end'] if isinstance(e, serving.RankFrontEnd)
          else None for e in ends]
      # the drill on the last replica, whose ranks are all remote
      drill = serving.ServingEnginePool(ends[-1:], max_delay_ms=2.0)
      try:
        for fut in [drill.submit(r) for r in reqs[:4]]:
          fut.result(timeout=120.0)
        drill.fail_replica(0)
      finally:
        drill.close()
      out['drill_link'] = ends[-1].stats()['front_end']
      out['drill_closed'] = ends[-1].link.closed
      for e in ends:
        if isinstance(e, serving.RankFrontEnd):
          e.close()
      out['links'] = [
          e.stats()['front_end'] if isinstance(e, serving.RankFrontEnd)
          else None for e in ends]
      out['engine_batches'] = engine.stats()['batches_served']
      np.savez(f'{out_dir}/replicas{rank}.npz', **got)
    with open(f'{out_dir}/replicas{rank}.json', 'w') as f:
      json.dump(out, f, default=str)
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()


def serve_replicas_fault(rank, world_size, init_method, case_path,
                         out_dir):
  """tests/test_torch_serving_replicas.py's fault case: replicas on
  ranks [0, 1] and [2, 3] behind one pool on rank 0; rank 3's lookup
  raises at ``case['fault_at']``, mid-burst, so it ends its process
  (``serve_forever``), and so does rank 2.  The front door waits for
  every future of the burst, then for each served request that was
  retried holds ``lookup_padded`` on replica 0 beside it, closes the
  pool and replica 0's link (rank 1 returns its counts) and saves
  ``fault0.json``.  No world-wide barrier or teardown: two ranks are
  gone."""
  import time

  import numpy as np
  import torch

  from distributed_embeddings_tpu_torch import serving
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.serving import frontend
  from distributed_embeddings_tpu_torch.serving import pool as pool_mod
  from distributed_embeddings_tpu_torch.serving.batcher import host_outputs

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  mesh_lib.init_distributed(init_method, world_size, rank, backend='gloo',
                            device='cpu')
  frontend.LEADER_TIMEOUT_S = case['timeout']
  ends, engine = _replica_ends(case, rank)
  if rank == 3:
    lookup = engine.lookup
    calls = []

    def faulty(cats, samples=None):
      calls.append(samples)
      if len(calls) == case['fault_at']:
        raise RuntimeError('injected follower fault in replica 1')
      return lookup(cats, samples=samples)

    engine.lookup = faulty
  if rank != 0:
    out = _follow(ends, engine)
    with open(f'{out_dir}/fault{rank}.json', 'w') as f:
      json.dump(out, f, default=str)
    return
  for e in ends:
    e.warmup()
  recorded = []
  req_init = pool_mod._PoolReq.__init__

  def record(self, *args, **kwargs):
    req_init(self, *args, **kwargs)
    recorded.append(self)

  pool_mod._PoolReq.__init__ = record
  pool = serving.ServingEnginePool(ends, max_delay_ms=1.0, queue_depth=64)
  t0 = time.monotonic()
  futs = [pool.submit(r) for r in case['burst']]
  outcomes = []
  for fut in futs:
    try:
      fut.result(timeout=case['timeout'] * 2)
      outcomes.append('served')
    except Exception as e:  # recorded, checked by the parent
      outcomes.append(type(e).__name__)
  out = {'outcomes': outcomes, 'resolve_s': time.monotonic() - t0,
         'pool_stats': pool.stats(),
         'retried': [r.retries for r in recorded]}
  pool_mod._PoolReq.__init__ = req_init
  same = []
  for req in recorded:
    if req.retries and req.future.error() is None:
      want = host_outputs(ends[0].lookup_padded(req.cats))
      same.append(all(np.array_equal(g, w) for g, w in
                      zip(req.future.result(timeout=0), want)))
  out['retried_bit_equal'] = same
  t0 = time.monotonic()
  pool.close()
  for e in ends:
    e.close()
  out['close_s'] = time.monotonic() - t0
  out['links'] = [e.stats()['front_end'] for e in ends]
  with open(f'{out_dir}/fault0.json', 'w') as f:
    json.dump(out, f, default=str)


def serve_fault(rank, world_size, init_method, case_path, out_dir):
  """tests/test_torch_serving_ranks.py's fault cases.  ``case['faulty']
  == 'follower'``: the follower's second lookup raises, so it ends its
  process (``serve_forever``).  ``'leader'``: the leader's second block
  raises after its forward, with the follower past its lookup.  Either
  way the leader's batch and every later request fail with
  ``ReplicaLostError``, it closes without hanging, and a follower left
  waiting on the control group fails at once and ends its process.  The
  leader saves ``fault0.json`` and lingers ``case['linger']`` seconds;
  it leaves its process group to the process's end (the link is
  gone)."""
  import time

  import torch

  from distributed_embeddings_tpu_torch import serving
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.serving import frontend

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu')
  frontend.LEADER_TIMEOUT_S = case['timeout']
  reqs = case['requests']
  eng = _serve_engine(case, m)
  fe = serving.RankFrontEnd(eng)
  if rank == 0 and case['faulty'] == 'leader':
    apply_block = eng.apply_block
    blocks = []

    def faulty_block(padded, b):
      outs = apply_block(padded, b)
      blocks.append(b)
      if len(blocks) == 2:
        raise RuntimeError('injected leader fault')
      return outs

    eng.apply_block = faulty_block
  if rank != 0 and case['faulty'] == 'follower':
    lookup = eng.lookup
    calls = []

    def faulty(cats, samples=None):
      calls.append(samples)
      if len(calls) == 2:
        raise RuntimeError('injected follower fault')
      return lookup(cats, samples=samples)

    eng.lookup = faulty
  if rank != 0:
    fe.serve_forever()
    raise AssertionError('serve_forever returned after a fault')
  out = {}
  bat = serving.DynamicBatcher(fe, max_delay_ms=1.0)
  out['first'] = [a.shape for a in bat.submit(reqs[2]).result(timeout=60.0)]
  t0 = time.monotonic()
  fut = bat.submit(reqs[3])
  out['second'] = _refusal(lambda: fut.result(timeout=case['timeout'] * 2))
  out['second_s'] = time.monotonic() - t0
  out['third'] = _refusal(
      lambda: bat.submit(reqs[4]).result(timeout=case['timeout']))
  t0 = time.monotonic()
  bat.close()
  fe.close()
  fe.close()
  out['close_s'] = time.monotonic() - t0
  out['lost'] = fe.stats()['front_end']['lost']
  with open(f'{out_dir}/fault{rank}.json', 'w') as f:
    json.dump(out, f, default=str)
  # the process (and its sockets) stays up a while: a follower that ends
  # before it was ended by the link, not by the leader's exit
  time.sleep(case['linger'])


def serve_py(rank, world_size, init_method, case_path, out_dir):
  """One rank of the port's ``serve.py`` across gloo ranks on the CPU
  (tests/test_torch_serving_ranks.py): ``main`` with the world's flags;
  on the leader every submitted request of the monolithic and ladder
  batchers and every served overload request is recorded, then held
  against a numpy gather of the bundle's rows (a ``-1`` id, which the
  degraded mode makes, answers zeros).  Saves ``serve_py{rank}.json``:
  what ``main`` returned and, on the leader, the checks' counts."""
  import numpy as np
  import torch

  from distributed_embeddings_tpu_torch import serving
  from distributed_embeddings_tpu_torch.examples.dlrm import serve
  from distributed_embeddings_tpu_torch.serving import batcher, pool

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  subs, reqs = [], []
  submit, req_init = batcher.DynamicBatcher.submit, pool._PoolReq.__init__

  def record(self, cats, *args, **kwargs):
    fut = submit(self, cats, *args, **kwargs)
    subs.append((cats, fut))
    return fut

  def record_req(self, *args, **kwargs):
    req_init(self, *args, **kwargs)
    reqs.append(self)

  batcher.DynamicBatcher.submit = record
  pool._PoolReq.__init__ = record_req
  got = serve.main(case['argv'] + [
      '--init_method', init_method, '--world_size', str(world_size),
      '--rank', str(rank), '--dist_backend', 'gloo'])
  out = {'returned': got}
  if rank == 0:
    weights, _ = serving.load_serving_bundle(case['bundle'])

    def gathered(cats):
      return [np.where((c >= 0)[:, None], w[np.maximum(c, 0)], 0)
              for c, w in zip(cats, weights)]

    def equal(answer, cats):
      return all(np.array_equal(a, g)
                 for a, g in zip(answer, gathered(cats)))

    ok = [(cats, fut) for cats, fut in subs if fut.error() is None]
    out['batched_served'] = len(ok)
    out['batched_equal'] = sum(
        equal(fut.result(timeout=0), [np.asarray(c) for c in cats])
        for cats, fut in ok)
    served = [r for r in reqs if r.future.error() is None]
    out['pool_resolved'] = sum(r.future.done() for r in reqs)
    out['pool_requests'] = len(reqs)
    out['pool_served'] = len(served)
    out['pool_degraded'] = sum(r.degraded for r in served)
    out['pool_equal'] = sum(
        equal(r.future.result(timeout=0), [np.asarray(c) for c in r.cats])
        for r in served)
  with open(f'{out_dir}/serve_py{rank}.json', 'w') as f:
    json.dump(out, f, default=str)


def commsan_fit(rank, world_size, init_method, case_path, out_dir):
  """One rank of the rendezvous sanitizer's drills (for
  tests/test_torch_commsan.py), each inside a ``commsan.capture``:
  ``'clean'`` runs ``grad.fit`` over ``case['steps']`` hybrid steps with
  a ``StateAuditor`` and a ``CheckpointCallback`` (every barrier must
  pass); ``'rollback'`` does the same with ``on_anomaly='rollback'``,
  and rank ``case['faulty_rank']`` alone raises ``TierIntegrityError``
  (a host-local detection) before step ``case['fault_step']``, so that
  rank alone restores the newest checkpoint and replays.  Saves each
  drill's digest, record count, barrier checks and the
  ``CommSequenceError`` it raised (None when none)."""
  import os

  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch import optim
  from distributed_embeddings_tpu_torch.analysis import commsan
  from distributed_embeddings_tpu_torch.parallel import audit
  from distributed_embeddings_tpu_torch.parallel import callbacks
  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import grad
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel import sparse
  from distributed_embeddings_tpu_torch.parallel.coldtier import (
      TierIntegrityError)
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding)
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu')
  results = {}
  try:
    tables = [TableConfig(r, w, combiner=c) for r, w, c in case['tables']]
    dist = DistributedEmbedding(tables, mesh=m, dp_input=True)
    b = case['batch'] // world_size
    data = [([c[rank * b:(rank + 1) * b] for c in cats],
             torch.tensor(y[rank * b:(rank + 1) * b]))
            for cats, y in case['batches']]

    def head(dense_params, emb_outs, y):
      x = torch.cat(list(emb_outs), dim=1)
      return torch.mean((x @ dense_params['kernel'] - y) ** 2)

    dense_opt, emb_opt = optim.adagrad(0.05), sparse.SparseAdagrad(0.05)
    step = sparse.make_hybrid_train_step(dist, head, dense_opt, emb_opt)
    for drill in ('clean', 'rollback'):
      ckpt_dir = os.path.join(out_dir, f'ckpt_{drill}')
      os.makedirs(ckpt_dir, exist_ok=True)
      torch_dist.barrier()
      state = sparse.init_hybrid_train_state(
          dist, {'embedding': checkpoint.set_weights(dist, case['weights']),
                 'kernel': torch.tensor(case['kernel'])},
          dense_opt, emb_opt)
      fired = []

      def fn(s, cats, y, drill=drill, fired=fired):
        if (drill == 'rollback' and rank == case['faulty_rank']
            and int(s.step) + 1 == case['fault_step'] and not fired):
          fired.append(int(s.step))
          raise TierIntegrityError([(0, rank, [0])])
        return step(s, cats, y)

      cb = callbacks.CheckpointCallback(
          dist, os.path.join(ckpt_dir, 'ckpt_{step}.npz'),
          every=case['every'])
      error = None
      with commsan.capture(drill, timeout_s=case['timeout_s']) as cap:
        try:
          grad.fit(fn, state, iter(data), steps=case['steps'],
                   log_every=case['every'], callbacks=[cb], verbose=False,
                   auditor=audit.StateAuditor(dist, every=case['every']),
                   on_anomaly='rollback' if drill == 'rollback' else None,
                   rollback_dir=ckpt_dir, dist=dist,
                   data_factory=lambda k: iter(data[k:]))
        except commsan.CommSequenceError as e:
          error = str(e)
      digest, count = cap.digest()
      results[drill] = {'digest': digest, 'records': count,
                        'checks': cap.checks, 'error': error,
                        'fired': fired, 'records_list': cap.records}
    with open(os.path.join(out_dir, f'commsan{rank}.json'), 'w') as f:
      json.dump(results, f)
  finally:
    torch_dist.destroy_process_group()
