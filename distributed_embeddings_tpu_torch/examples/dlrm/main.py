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

``--hot_cache`` (with ``--dp_input`` and the sparse trainer) calibrates
hot sets over ``--hot_calib_batches`` dummy batches, as the JAX example
does (``--hot_coverage``, ``--hot_budget_mb``), and trains with the
hot-row cache.

``--table_dtype int8`` / ``float8_e4m3`` (with the sparse trainer and
``--param_dtype float32``, as in the JAX example) stores the tables
quantized, one f32 power-of-two scale a row (docs/design.md §12), and
prints the storage line of ``quantization.table_bytes_stats``.

It parses the JAX example's flags.  Those that select something the port
does not have yet raise ``NotImplementedError`` naming the ROADMAP.md
item that ports it (``--dataset_path`` is item 12); ``--fast_compile``
is an XLA compile option with no counterpart here, and
``--segwalk_apply`` names the port's only embedding apply, so it
changes nothing.  ``--device`` (default
``cuda``) is the port's own flag: ``--device cpu`` runs every kernel's
plain PyTorch version.

Checkpoints are the JAX example's files (either package resumes the
other's): ``--save_weights`` (the reference's positional ``arr_i``
tables), ``--save_state`` (a resumable ``save_train_npz`` file),
``--load_state`` (resume from one file) and ``--resume_dir`` (resume
from the newest valid file of a directory).  A resume skips the batches
the resumed run consumed; ``--max_steps`` counts the steps of this
invocation, as in the JAX example.  One difference: an auto-resume from
``--resume_dir`` also quarantines (renames ``*.corrupt``) the candidates
that fail verification, as the rollback path does, so no later resume
rescans known-bad bytes.  ``--audit_every`` audits the state
(``parallel.audit.StateAuditor``); ``--on_anomaly rollback`` restores
the newest valid file of ``--resume_dir`` in place and skips the
offending window (at most ``--rollback_budget`` times); ``--eval_every``
evaluates AUC during training and prints the curve.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
import time

import numpy as np
import torch

from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.models.dlrm import DLRM, bce_with_logits
from distributed_embeddings_tpu_torch.parallel import (checkpoint, grad,
                                                       hotcache,
                                                       quantization, sparse)
from distributed_embeddings_tpu_torch.parallel.audit import StateAuditor
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    not_ported)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.utils import resilience
from distributed_embeddings_tpu_torch.utils.data import DummyDataset
from distributed_embeddings_tpu_torch.utils.metrics import StreamingAUC
from distributed_embeddings_tpu_torch.utils.schedules import (
    warmup_poly_decay_schedule)

# flags that select what the port does not have yet -> the ROADMAP.md
# Queue 1 item that ports them; each raises when set off its default
UNPORTED = {
    'dataset_path': 12, 'wire_dtype': 9,
    'cold_tier_budget_mb': 12, 'csr_feed': 12, 'on_batch_error': 12,
    'loader_bench': 12, 'trace': 14,
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
                 help='frequency-aware hot-row cache: calibrate hot sets '
                 'from --hot_calib_batches batches and replicate them '
                 '(needs --dp_input and --trainer sparse)')
  p.add_argument('--overlap_chunks', type=int, default=1,
                 help='split the dp<->mp exchanges into this many slot '
                 'chunks pipelined against the lookup (needs --dp_input '
                 'and --trainer sparse)')
  p.add_argument('--fused_exchange', default=True,
                 action=argparse.BooleanOptionalAction,
                 help='one collective per exchange phase (default); '
                 '--no-fused_exchange: one per group')
  p.add_argument('--wire_dtype', default='none',
                 choices=['none', 'bfloat16', 'table'],
                 help='not ported (item 9)')
  p.add_argument('--hot_coverage', type=float, default=0.8,
                 help='per-table occurrence coverage target of the hot '
                 'sets')
  p.add_argument('--hot_calib_batches', type=int, default=2,
                 help='batches counted to calibrate the hot sets')
  p.add_argument('--hot_budget_mb', type=float, default=None,
                 help='per-device replication budget of the hot rows and '
                 'their optimizer state (None = unbudgeted)')
  p.add_argument('--table_dtype', default='none',
                 choices=['none', 'int8', 'float8_e4m3'],
                 help='quantized table storage: int8 / fp8 payload plus '
                 'one f32 scale per row (needs --trainer sparse and '
                 '--param_dtype float32)')
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
                 help='evaluate AUC every N steps (0 = off)')
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
                 help='save the tables as the reference\'s arr_i npz')
  p.add_argument('--trainer', default='sparse', choices=['sparse', 'dense'],
                 help='sparse = row-wise embedding updates; dense = '
                 'autodiff through the whole model (reference parity)')
  p.add_argument('--save_state', default=None,
                 help='save a resumable checkpoint (tables, optimizer '
                 'state, step) at the end')
  p.add_argument('--load_state', default=None,
                 help='resume from this checkpoint file')
  p.add_argument('--resume_dir', default=None,
                 help='resume from the newest valid checkpoint here '
                 '(corrupt candidates are quarantined); the rollback '
                 'directory of --on_anomaly rollback')
  p.add_argument('--on_batch_error', default='raise',
                 choices=['raise', 'skip'], help='not ported (item 12)')
  p.add_argument('--audit_every', type=int, default=0,
                 help='state-integrity audit every N steps (0 = off; '
                 'needs --trainer sparse)')
  p.add_argument('--on_anomaly', default='terminate',
                 choices=['terminate', 'rollback'],
                 help='on a non-finite loss or a failed audit: exit 3, '
                 'or roll back to the newest valid checkpoint of '
                 '--resume_dir and skip the offending window')
  p.add_argument('--rollback_budget', type=int, default=2,
                 help='in-process rollbacks before terminating')
  p.add_argument('--trace', default=None, metavar='PATH',
                 help='not ported (item 14)')
  p.add_argument('--device', default='cuda',
                 help="the device to run on: cuda (default) or cpu")
  return p


def refuse_unported(args, parser: argparse.ArgumentParser):
  for name, item in UNPORTED.items():
    if getattr(args, name) != parser.get_default(name):
      raise not_ported(f'--{name}', item)
  if args.overlap_chunks > 1:
    if not args.dp_input:
      raise SystemExit('--overlap_chunks > 1 requires --dp_input (the '
                       'chunked pipeline overlaps the dp->mp id '
                       'exchange, which only the data-parallel input '
                       'path has)')
    if args.trainer != 'sparse':
      raise SystemExit('--overlap_chunks > 1 pairs with --trainer '
                       'sparse (the chunked gradient exchange/apply '
                       'lives in the sparse row-wise path)')
  if args.table_dtype != 'none':
    if args.trainer != 'sparse':
      raise SystemExit('--table_dtype requires --trainer sparse (dense '
                       'autodiff cannot differentiate through integer '
                       'payloads; design §12 refusal matrix)')
    if args.param_dtype != 'float32':
      raise SystemExit('--table_dtype requires --param_dtype float32 '
                       '(the per-row scale carries the dynamic range; '
                       'design §12 refusal matrix)')
  if args.fast_compile:
    raise ValueError('--fast_compile sets XLA compile options; the port '
                     'compiles nothing at run time')


def calibrate_hot_sets(args, table_sizes):
  """The hot sets of ``--hot_cache``: id counts over
  ``--hot_calib_batches`` batches of the dummy data (``--dataset_path``
  is item 12), at ``--hot_coverage`` and within ``--hot_budget_mb``, as
  the JAX example calibrates them.  Refuses ``--hot_cache`` without
  ``--dp_input`` or with ``--trainer dense``, as the JAX example does."""
  if not args.dp_input:
    raise SystemExit('--hot_cache requires --dp_input (the cache '
                     'partitions the dp->mp id exchange, which only '
                     'the data-parallel input path has)')
  if args.trainer != 'sparse':
    raise SystemExit('--hot_cache pairs with --trainer sparse (the '
                     'split hot/cold optimizer state lives in the '
                     'sparse row-wise path)')
  cal_ids = list(range(len(table_sizes)))
  cal_ds = DummyDataset(args.batch_size, args.num_numerical_features,
                        len(cal_ids), args.hot_calib_batches)
  cfgs = [TableConfig(s, args.embedding_dim) for s in table_sizes]
  batches = []
  for bi, (_, cats_b, _) in enumerate(cal_ds):
    if bi >= args.hot_calib_batches:
      break
    batches.append([np.asarray(c) for c in cats_b])
  hot_sets = hotcache.calibrate_hot_sets(
      cfgs, cal_ids, batches, coverage=args.hot_coverage,
      budget_bytes=(int(args.hot_budget_mb * 2**20)
                    if args.hot_budget_mb else None))
  print(f'hot_cache: calibrated '
        f'{sum(h.size for h in hot_sets.values())} hot rows over '
        f'{len(hot_sets)} table(s) from {len(batches)} batch(es) '
        f'(coverage target {args.hot_coverage})')
  return hot_sets


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
  hot_sets = calibrate_hot_sets(args, table_sizes) if args.hot_cache else None
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
               hot_cache=hot_sets,
               overlap_chunks=args.overlap_chunks,
               fused_exchange=args.fused_exchange,
               table_dtype=(None if args.table_dtype == 'none'
                            else args.table_dtype),
               param_dtype=param_dtype,
               compute_dtype=getattr(torch, args.compute_dtype
                                     or args.param_dtype),
               device=args.device).init(0)
  dist = model.dist_embedding
  device = dist.device
  if args.table_dtype != 'none':
    tb = quantization.table_bytes_stats(dist.plan)
    print(f"table_dtype: {tb['table_dtype']} — "
          f"{tb['table_bytes_per_row']:.1f} payload B/row + "
          f"{tb['table_scale_bytes_per_row']} scale B/row over "
          f"{tb['table_rows']:,} rows "
          f"({tb['table_payload_bytes'] + tb['table_scale_bytes']:,} "
          f"bytes total vs {tb['table_payload_bytes'] * 4:,} at f32)")

  if args.dp_input:
    table_ids = list(range(len(table_sizes)))
  else:
    table_ids = [i for dev in dist.plan.input_ids_list for i in dev]
  train_dataset = DummyDataset(args.batch_size, args.num_numerical_features,
                               len(table_ids), args.num_batches)
  eval_dataset = DummyDataset(args.batch_size, args.num_numerical_features,
                              len(table_ids), 10)

  step, state = make_trainer(model, args.trainer, args.learning_rate)

  # resume: one file (--load_state) or the newest VALID file of
  # --resume_dir; restore_train_state reshards the tables and sparse
  # optimizer state and restores the MLPs and both schedules' counts
  resume_step = 0
  resume_source = args.load_state or (
      args.resume_dir if args.resume_dir and os.path.isdir(args.resume_dir)
      else None)
  resumed_from = None
  timings = {}
  if resume_source is not None:
    t0 = time.perf_counter()
    try:
      state, resumed_from = checkpoint.restore_train_state(
          dist, state, resume_source,
          quarantine=args.load_state is None)
    except FileNotFoundError as e:
      if args.load_state:
        raise
      print(f'resume_dir: no valid checkpoint yet ({e}); starting fresh')
    else:
      resume_step = int(state.step)
      timings['restore_s'] = time.perf_counter() - t0
      print(f'resumed from {resumed_from} at step {resume_step} in '
            f'{timings["restore_s"]:.2f} s')

  auc_history = []

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
    auc_history.append((step_no, auc))
    print(f'step: {step_no}  eval AUC: {auc:.5f}', flush=True)
    return auc

  # self-healing: periodic state audits, and terminate (exit 3) or roll
  # back in place.  The loop's input is sequential, so a rollback keeps
  # the current input position: the window between the restored step and
  # the detection is skipped (journaled), as in the JAX example.
  auditor = None
  if args.audit_every > 0:
    if args.trainer != 'sparse':
      raise SystemExit('--audit_every requires --trainer sparse (the '
                       'auditor checks the hybrid embedding state)')
    auditor = StateAuditor(dist, every=args.audit_every)
    print(f'audit: state-integrity checks every {args.audit_every} '
          f'step(s), on_anomaly={args.on_anomaly}')
  if args.on_anomaly == 'rollback' and not args.resume_dir:
    raise SystemExit('--on_anomaly rollback needs --resume_dir (the '
                     'checkpoint directory to restore from)')
  rollbacks = 0

  def handle_anomaly(step_no, why):
    """Exit 3, or roll back in place and return.  A sibling of fit's
    handler (parallel/grad.py) with the same journal events: this loop
    exits with a process code and cannot rewind its input."""
    nonlocal state, rollbacks
    policy = ('rollback_skip' if args.on_anomaly == 'rollback'
              else args.on_anomaly)
    resilience.journal('anomaly_detected', anomaly=why, step=step_no,
                       policy=policy)
    if args.on_anomaly == 'rollback' and rollbacks < args.rollback_budget:
      try:
        state, pth = checkpoint.restore_train_state(
            dist, state, args.resume_dir, quarantine=True)
      except (FileNotFoundError, ValueError) as e:
        resilience.journal('rollback_failed', step=step_no, anomaly=why,
                           error=str(e))
        print(f'on_anomaly=rollback: {why} at step {step_no} and no '
              f'valid checkpoint to roll back to ({e}); terminating')
        sys.exit(3)
      rollbacks += 1
      resilience.journal('rollback', anomaly=why, detect_step=step_no,
                         at_step=step_no, to_step=int(state.step),
                         path=pth, attempt=rollbacks, policy=policy)
      resilience.journal('skip_window', from_step=int(state.step),
                         to_step=step_no,
                         batches=step_no - int(state.step))
      print(f'on_anomaly=rollback: {why} at step {step_no} -> restored '
            f'{pth} at step {int(state.step)} (attempt {rollbacks}/'
            f'{args.rollback_budget}); input continues at the current '
            'batch (offending window skipped)')
      return
    if args.on_anomaly == 'rollback':
      resilience.journal('rollback_budget_exhausted',
                         budget=args.rollback_budget, step=step_no,
                         anomaly=why)
      print(f'on_anomaly=rollback: {why} at step {step_no} but the '
            f'rollback budget ({args.rollback_budget}) is exhausted; '
            'terminating')
    else:
      print(f'on_anomaly=terminate: {why} at step {step_no}; '
            'terminating (journaled)')
    sys.exit(3)

  start = time.perf_counter()
  steady_start = None  # after the warm-up steps, which load the kernels
  samples = 0
  loss = None
  data_iter = iter(train_dataset)
  if resume_step:
    # skip the batches the resumed run consumed (one epoch at most)
    data_iter = itertools.islice(
        data_iter, resume_step % max(1, len(train_dataset)), None)
  for i, (numerical, cats, labels) in enumerate(data_iter):
    state, loss = step(state, numerical, list(cats), labels)
    samples += args.batch_size
    step_no = resume_step + i + 1
    if auditor is not None and (i + 1) % args.audit_every == 0:
      findings = auditor.check_state(state, step=step_no)
      if findings:
        handle_anomaly(step_no, 'audit_failure: '
                       + '; '.join(f.brief() for f in findings[:3]))
      elif not np.isfinite(float(loss)):  # the audit paid the sync
        handle_anomaly(step_no, 'non_finite_loss')
    elif i % 1000 == 0 and not np.isfinite(float(loss)):
      handle_anomaly(step_no, 'non_finite_loss')
    if i == 2:
      _sync(device)
      steady_start = (time.perf_counter(), samples)
    if i % 1000 == 0:
      print(f'step: {resume_step + i}  loss: {float(loss):.5f}')
    if args.eval_every and (i + 1) % args.eval_every == 0:
      run_eval(step_no)
    if args.max_steps and i + 1 >= args.max_steps:
      break
  if loss is None:
    print('no batches to train on (resume skipped the whole dataset)')
    return None
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
  if len(auc_history) > 1:
    print('AUC curve: ' + ' '.join(f'{s}:{a:.4f}' for s, a in auc_history))

  weights = None
  t0 = time.perf_counter()
  if args.save_weights or args.save_state:
    weights = checkpoint.export_tables(dist, state.params['embedding'])
  if args.save_weights:
    checkpoint.save_npz(args.save_weights, weights)
    print(f'saved embedding weights to {args.save_weights}')
  if args.save_state:
    st_tables = (checkpoint.get_optimizer_state(dist, state.opt_state[1])
                 if args.trainer == 'sparse' else None)
    checkpoint.save_train_npz(
        args.save_state, weights, st_tables,
        extras=checkpoint.train_extras(dist, state,
                                       sparse=args.trainer == 'sparse'),
        plan=dist)
    timings['save_s'] = time.perf_counter() - t0
    print(f'saved resumable state to {args.save_state} in '
          f'{timings["save_s"]:.2f} s (the tables\' device-to-host copy '
          'included)')
  return {'step': int(state.step), 'loss': float(loss),
          'resumed_from': resumed_from, 'auc': auc_history, **timings}

if __name__ == '__main__':
  main()
