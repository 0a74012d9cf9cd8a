"""DLRM training example on PyTorch: the port's counterpart of
``examples/dlrm/main.py``.

MLPerf-configuration DLRM over synthetic dummy data, hybrid data- and
model-parallel, then AUC evaluation.  One process on one device.  Two
trainers, both SGD on the warm-up + poly-decay schedule: ``--trainer
sparse`` (the default) updates the embedding tables row-wise through the
segment-walk apply and the MLPs by SGD; ``--trainer dense`` (the
reference-parity path) differentiates the whole model, tables included,
and updates every param by the same SGD (``parallel/grad.py``
``make_train_step``).

    python -m distributed_embeddings_tpu_torch.examples.dlrm.main \\
        [--num_batches 100] [--param_dtype bfloat16] [--device cuda]

It parses the JAX example's flags.  Those that select something the port
does not have yet raise ``NotImplementedError`` naming the ROADMAP.md
item that ports it (``--dataset_path`` is item 12); ``--fast_compile``
is an XLA compile option with no counterpart here, and
``--segwalk_apply`` names the port's only embedding apply, so it
changes nothing.  ``--device`` (default
``cuda``) is the port's own flag: ``--device cpu`` runs every kernel's
plain PyTorch version.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.models.dlrm import DLRM, bce_with_logits
from distributed_embeddings_tpu_torch.parallel import grad, sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    not_ported)
from distributed_embeddings_tpu_torch.utils.data import DummyDataset
from distributed_embeddings_tpu_torch.utils.metrics import StreamingAUC
from distributed_embeddings_tpu_torch.utils.schedules import (
    warmup_poly_decay_schedule)

# flags that select what the port does not have yet -> the ROADMAP.md
# Queue 1 item that ports them; each raises when set off its default
UNPORTED = {
    'dataset_path': 12, 'hot_cache': 7, 'hot_coverage': 7,
    'hot_calib_batches': 7, 'hot_budget_mb': 7, 'overlap_chunks': 8,
    'fused_exchange': 8, 'wire_dtype': 9, 'table_dtype': 9,
    'cold_tier_budget_mb': 12, 'csr_feed': 12, 'on_batch_error': 12,
    'loader_bench': 12, 'eval_every': '3c',
    'save_weights': 11, 'save_state': 11, 'load_state': 11,
    'resume_dir': '3c', 'audit_every': '3c', 'on_anomaly': '3c',
    'rollback_budget': '3c', 'trace': 14,
}


def build_parser() -> argparse.ArgumentParser:
  """The JAX example's flags, plus ``--device``."""
  p = argparse.ArgumentParser(description='DLRM on PyTorch')
  p.add_argument('--dataset_path', default=None,
                 help='Criteo split-binary dataset (not ported: item 12)')
  p.add_argument('--learning_rate', type=float, default=24)
  p.add_argument('--batch_size', type=int, default=64 * 1024)
  p.add_argument('--top_mlp_dims', default='1024,1024,512,256,1')
  p.add_argument('--bottom_mlp_dims', default='512,256,128')
  p.add_argument('--num_numerical_features', type=int, default=13)
  p.add_argument('--num_batches', type=int, default=340)
  p.add_argument('--table_sizes', default=','.join(['1000'] * 26))
  p.add_argument('--embedding_dim', type=int, default=128)
  p.add_argument('--dp_input', action='store_true',
                 help='data-parallel categorical inputs (default: '
                 'model-parallel, in worker order)')
  p.add_argument('--dist_strategy', default='memory_balanced')
  p.add_argument('--column_slice_threshold', type=int, default=None)
  p.add_argument('--segwalk_apply', action='store_true',
                 help='the segment-walk table apply: the port\'s only '
                 'embedding apply, so this changes nothing')
  p.add_argument('--row_slice', type=int, default=None,
                 help='element threshold above which tables shard along '
                 'rows')
  p.add_argument('--hot_cache', action='store_true',
                 help='not ported (item 7)')
  p.add_argument('--overlap_chunks', type=int, default=1,
                 help='> 1: not ported (item 8)')
  p.add_argument('--fused_exchange', default=True,
                 action=argparse.BooleanOptionalAction,
                 help='--no-fused_exchange: not ported (item 8)')
  p.add_argument('--wire_dtype', default='none',
                 choices=['none', 'bfloat16', 'table'],
                 help='not ported (item 9)')
  p.add_argument('--hot_coverage', type=float, default=0.8,
                 help='not ported (item 7)')
  p.add_argument('--hot_calib_batches', type=int, default=2,
                 help='not ported (item 7)')
  p.add_argument('--hot_budget_mb', type=float, default=None,
                 help='not ported (item 7)')
  p.add_argument('--table_dtype', default='none',
                 choices=['none', 'int8', 'float8_e4m3'],
                 help='not ported (item 9)')
  p.add_argument('--cold_tier_budget_mb', type=float, default=None,
                 help='not ported (item 12)')
  p.add_argument('--param_dtype', default='float32',
                 choices=['float32', 'bfloat16'],
                 help='table + MLP storage dtype (bfloat16 halves the '
                 'table bytes: the AMP-baseline analog)')
  p.add_argument('--compute_dtype', default=None,
                 choices=['float32', 'bfloat16'],
                 help='activation dtype (default: param_dtype)')
  p.add_argument('--eval', action='store_true',
                 help='run AUC evaluation after training')
  p.add_argument('--eval_every', type=int, default=0,
                 help='not ported (item 3c)')
  p.add_argument('--eval_batches', type=int, default=0,
                 help='cap eval to this many batches (0 = all)')
  p.add_argument('--loader_bench', action='store_true',
                 help='not ported (item 12)')
  p.add_argument('--csr_feed', action='store_true',
                 help='not ported (item 12)')
  p.add_argument('--fast_compile', action='store_true',
                 help='an XLA compile option: no counterpart in the port')
  p.add_argument('--max_steps', type=int, default=0,
                 help='stop after this many train steps (0 = the whole '
                 'dataset)')
  p.add_argument('--save_weights', default=None,
                 help='not ported (item 11)')
  p.add_argument('--trainer', default='sparse', choices=['sparse', 'dense'],
                 help='sparse = row-wise embedding updates; dense = '
                 'autodiff through the whole model (reference parity)')
  p.add_argument('--save_state', default=None, help='not ported (item 11)')
  p.add_argument('--load_state', default=None, help='not ported (item 11)')
  p.add_argument('--resume_dir', default=None, help='not ported (item 3c)')
  p.add_argument('--on_batch_error', default='raise',
                 choices=['raise', 'skip'], help='not ported (item 12)')
  p.add_argument('--audit_every', type=int, default=0,
                 help='not ported (item 3c)')
  p.add_argument('--on_anomaly', default='terminate',
                 choices=['terminate', 'rollback'],
                 help='rollback is not ported (item 3c); a non-finite '
                 'loss terminates (exit 3)')
  p.add_argument('--rollback_budget', type=int, default=2,
                 help='not ported (item 3c)')
  p.add_argument('--trace', default=None, metavar='PATH',
                 help='not ported (item 14)')
  p.add_argument('--device', default='cuda',
                 help="the device to run on: cuda (default) or cpu")
  return p


def refuse_unported(args, parser: argparse.ArgumentParser):
  for name, item in UNPORTED.items():
    if getattr(args, name) != parser.get_default(name):
      raise not_ported(f'--{name}', item)
  if args.fast_compile:
    raise ValueError('--fast_compile sets XLA compile options; the port '
                     'compiles nothing at run time')


def make_trainer(model: DLRM, trainer: str, learning_rate: float):
  """The example's trainer for ``model``: ``(step, state)``, ``step(state,
  numerical, cats, labels) -> (state, loss)`` with ``cats`` as
  ``model.dist_embedding.apply`` takes them.  Both trainers run SGD on
  the reference's warm-up + poly-decay schedule and the mean BCE (JAX
  ``examples/dlrm/main.py``): ``'sparse'`` updates the tables through
  ``SparseSGD`` and the MLPs by SGD (``make_hybrid_train_step``);
  ``'dense'`` differentiates the whole model and updates every param,
  tables included, by the same SGD (``grad.make_train_step``)."""
  schedule = warmup_poly_decay_schedule(base_lr=learning_rate,
                                        warmup_steps=8000,
                                        decay_start_step=48000,
                                        decay_steps=24000)
  optimizer = optim.sgd(schedule)
  dist = model.dist_embedding
  params = {'embedding': model.embedding_params, **model.dense_params()}
  if trainer == 'dense':
    def loss_fn(p, batch):
      numerical, cats, labels = batch
      return bce_with_logits(model.apply(p, numerical, list(cats)), labels)

    dense_step = grad.make_train_step(loss_fn, optimizer,
                                      group=dist.mesh.group)
    return (lambda state, numerical, cats, labels: dense_step(
        state, (numerical, cats, labels)),
            grad.init_train_state(params, optimizer))

  # embedding tables update through row-wise sparse SGD (exact; the
  # reference's IndexedSlices path), the MLPs through optax-style SGD
  def head_loss_fn(dense_params, emb_outs, hbatch):
    numerical, labels = hbatch
    return bce_with_logits(model.head(dense_params, numerical, emb_outs),
                           labels)

  emb_opt = sparse.SparseSGD(learning_rate=learning_rate)
  hybrid_step = sparse.make_hybrid_train_step(dist, head_loss_fn, optimizer,
                                              emb_opt, lr_schedule=schedule)
  return (lambda state, numerical, cats, labels: hybrid_step(
      state, cats, (numerical, labels)),
          sparse.init_hybrid_train_state(dist, params, optimizer, emb_opt))


def _sync(device: torch.device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def main(argv=None):
  parser = build_parser()
  args = parser.parse_args(argv)
  refuse_unported(args, parser)

  table_sizes = [int(s) for s in args.table_sizes.split(',')]
  param_dtype = getattr(torch, args.param_dtype)
  model = DLRM(table_sizes=table_sizes,
               embedding_dim=args.embedding_dim,
               bottom_mlp_dims=[int(d) for d in
                                args.bottom_mlp_dims.split(',')],
               top_mlp_dims=[int(d) for d in args.top_mlp_dims.split(',')],
               num_numerical_features=args.num_numerical_features,
               dist_strategy=args.dist_strategy,
               column_slice_threshold=args.column_slice_threshold,
               row_slice=args.row_slice,
               dp_input=args.dp_input,
               param_dtype=param_dtype,
               compute_dtype=getattr(torch, args.compute_dtype
                                     or args.param_dtype),
               device=args.device).init(0)
  dist = model.dist_embedding
  device = dist.device

  if args.dp_input:
    table_ids = list(range(len(table_sizes)))
  else:
    table_ids = [i for dev in dist.plan.input_ids_list for i in dev]
  train_dataset = DummyDataset(args.batch_size, args.num_numerical_features,
                               len(table_ids), args.num_batches)
  eval_dataset = DummyDataset(args.batch_size, args.num_numerical_features,
                              len(table_ids), 10)

  step, state = make_trainer(model, args.trainer, args.learning_rate)

  def run_eval(step_no):
    auc_metric = StreamingAUC(num_thresholds=8000)
    with torch.no_grad():
      for bi, (numerical, cats, labels) in enumerate(eval_dataset):
        if args.eval_batches and bi >= args.eval_batches:
          break
        preds = torch.sigmoid(model.apply(state.params, numerical,
                                          list(cats)))
        auc_metric.update(labels, preds.float().cpu().numpy())
    auc = auc_metric.result()
    print(f'step: {step_no}  eval AUC: {auc:.5f}', flush=True)
    return auc

  start = time.perf_counter()
  steady_start = None  # after the warm-up steps, which load the kernels
  samples = 0
  loss = None
  for i, (numerical, cats, labels) in enumerate(train_dataset):
    state, loss = step(state, numerical, list(cats), labels)
    samples += args.batch_size
    if i % 1000 == 0:
      if not np.isfinite(float(loss)):
        print(f'on_anomaly=terminate: non_finite_loss at step {i + 1}; '
              'terminating')
        sys.exit(3)
      print(f'step: {i}  loss: {float(loss):.5f}')
    if i == 2:
      _sync(device)
      steady_start = (time.perf_counter(), samples)
    if args.max_steps and i + 1 >= args.max_steps:
      break
  if loss is None:
    print('no batches to train on')
    return
  _sync(device)
  elapsed = time.perf_counter() - start
  print(f'trained {samples} samples in {elapsed:.1f}s '
        f'({samples / elapsed:,.0f} samples/s on {dist.world_size} '
        f'device(s))')
  if steady_start is not None and samples > steady_start[1]:
    t0, s0 = steady_start
    dt = time.perf_counter() - t0
    print(f'steady-state: {(samples - s0) / dt:,.0f} samples/s '
          f'({samples - s0} samples after warmup; reference DLRM '
          f'8xA100 TF32: 9,158,000 samples/s)')
  if args.eval:
    auc = run_eval(int(state.step))
    print(f'Evaluation completed, AUC: {auc:.5f}')


if __name__ == '__main__':
  main()
