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

``--wire_dtype bfloat16`` / ``table`` (with ``--fused_exchange`` and the
sparse trainer; ``table`` with ``--table_dtype``, as in the JAX example)
narrows what the exchange ships (docs/design.md §24) and prints the
recorded legs' on-wire bytes beside their compute-dtype bytes
(``planner.reconcile_exchange``).  A world of one ships nothing, so
there no leg is narrowed.

``--dataset_path DIR`` trains on a split-binary Criteo dataset (table
sizes from its ``model_size.json``, as in the JAX example; written by
``gen_data.py``), read by the native loader when it builds and by the
Python reader otherwise (``utils/fastloader.open_raw_binary_dataset``);
``--loader_bench`` first times the reader alone and prints which one
ran.  ``--cold_tier_budget_mb MB`` (with ``--dp_input``, ``--hot_cache``
and the sparse trainer, as in the JAX example) keeps each group's head
within MB of table memory on the device and its tail rows in host
memory (docs/design.md §12); the fetch pre-pass of the next batch runs
on a worker thread during the step (``coldtier.ColdFetchPipeline``), and
the tier's geometry and the pipeline's overlap are printed.  The fetch
capacity of each tiered group is sized on one more batch that the hot-set
calibration reads and leaves out of the hot sets: the calibration
batches are the ones the hot sets cover best, so they need the fewest
tail rows, and a capacity sized on them is overflowed by later batches.

It parses the JAX example's flags.  Those that select something the port
does not have yet raise ``NotImplementedError`` naming the ROADMAP.md
item that ports it (``--csr_feed`` and ``--on_batch_error`` drive the
SparseCore feed, item 15); ``--fast_compile``
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
import collections
import itertools
import json
import os
import sys
import time

import numpy as np
import torch

from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.models.dlrm import DLRM, bce_with_logits
from distributed_embeddings_tpu_torch.parallel import (checkpoint, coldtier,
                                                       grad, hotcache,
                                                       planner,
                                                       quantization, sparse)
from distributed_embeddings_tpu_torch.parallel.audit import StateAuditor
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    not_ported)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.utils import resilience
from distributed_embeddings_tpu_torch.utils import fastloader
from distributed_embeddings_tpu_torch.utils.data import DummyDataset
from distributed_embeddings_tpu_torch.utils.metrics import StreamingAUC
from distributed_embeddings_tpu_torch.utils.schedules import (
    warmup_poly_decay_schedule)

# flags that select what the port does not have yet -> the ROADMAP.md
# Queue 1 item that ports them; each raises when set off its default
UNPORTED = {'csr_feed': 15, 'on_batch_error': 15, 'trace': 14}


def build_parser() -> argparse.ArgumentParser:
  """The JAX example's flags, plus ``--device``."""
  p = argparse.ArgumentParser(description='DLRM on PyTorch')
  p.add_argument('--dataset_path', default=None,
                 help='Criteo split-binary dataset directory (train/, '
                 'test/, model_size.json); default: dummy data')
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
                 help='wire format of the exchange\'s row and gradient '
                 'legs: bfloat16 casts the float legs on the wire; table '
                 'ships a quantized table\'s stored payload and scale '
                 '(bit-exact; needs --table_dtype).  Needs '
                 '--fused_exchange and --trainer sparse')
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
                 help='host-DRAM cold tier: per-device table budget in '
                 'MB; each group\'s tail rows beyond it live in host '
                 'memory and stream through the deduplicated cold '
                 'exchange (needs --dp_input, --hot_cache and --trainer '
                 'sparse)')
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
                 help='time the data reader alone before training and '
                 'print which reader ran')
  p.add_argument('--csr_feed', action='store_true',
                 help='not ported (item 15: the SparseCore feed)')
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
                 choices=['raise', 'skip'],
                 help='not ported (item 15: the SparseCore feed)')
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
  if args.wire_dtype != 'none':
    if not args.fused_exchange:
      raise SystemExit('--wire_dtype requires --fused_exchange: the '
                       'codec lives at the fused-leg seam '
                       '(docs/design.md §24)')
    if args.trainer != 'sparse':
      raise SystemExit('--wire_dtype pairs with --trainer sparse (the '
                       'gradient legs it narrows ride the sparse '
                       'row-wise backward)')
    if args.wire_dtype == 'table' and args.table_dtype == 'none':
      raise SystemExit("--wire_dtype table requires --table_dtype "
                       "(int8/float8_e4m3): the passthrough ships the "
                       "stored quantized payload; use --wire_dtype "
                       "bfloat16 for f32 tables")
  if args.cold_tier_budget_mb is not None:
    if not args.dp_input or not args.hot_cache:
      raise SystemExit('--cold_tier_budget_mb requires --dp_input and '
                       '--hot_cache: the tier streams tail rows '
                       'through the deduplicated cold exchange of the '
                       'hot-cache forward (design §12 refusal matrix)')
    if args.trainer != 'sparse':
      raise SystemExit('--cold_tier_budget_mb requires --trainer sparse '
                       '(tier writeback rides the sparse apply)')
  if args.fast_compile:
    raise ValueError('--fast_compile sets XLA compile options; the port '
                     'compiles nothing at run time')


def open_dataset(args, table_ids, table_sizes, valid=False,
                 prefetch_depth=10):
  """A reader of ``--dataset_path``'s split (whole batches: one process
  reads its batch), as the JAX example opens it."""
  return fastloader.open_raw_binary_dataset(
      data_path=args.dataset_path, batch_size=args.batch_size,
      numerical_features=args.num_numerical_features,
      categorical_features=table_ids,
      categorical_feature_sizes=table_sizes,
      prefetch_depth=prefetch_depth, drop_last_batch=True, offset=0,
      lbs=args.batch_size, dp_input=args.dp_input, valid=valid)


def calibrate_hot_sets(args, table_sizes):
  """The hot sets of ``--hot_cache``: id counts over
  ``--hot_calib_batches`` batches of ``--dataset_path`` (a reader of its
  own, closed after) or of the dummy data, at ``--hot_coverage`` and
  within ``--hot_budget_mb``, as the JAX example calibrates them.
  Refuses ``--hot_cache`` without ``--dp_input`` or with ``--trainer
  dense``, as the JAX example does.  Returns ``(hot_sets, held_out)``:
  with ``--cold_tier_budget_mb`` one batch more is read and held out of
  the hot sets (the cold tier's fetch capacity is sized on it); else
  ``held_out`` is empty."""
  if not args.dp_input:
    raise SystemExit('--hot_cache requires --dp_input (the cache '
                     'partitions the dp->mp id exchange, which only '
                     'the data-parallel input path has)')
  if args.trainer != 'sparse':
    raise SystemExit('--hot_cache pairs with --trainer sparse (the '
                     'split hot/cold optimizer state lives in the '
                     'sparse row-wise path)')
  cal_ids = list(range(len(table_sizes)))
  n_read = args.hot_calib_batches + (args.cold_tier_budget_mb is not None)
  if args.dataset_path is not None:
    cal_ds = open_dataset(args, cal_ids, table_sizes, prefetch_depth=2)
  else:
    cal_ds = DummyDataset(args.batch_size, args.num_numerical_features,
                          len(cal_ids), n_read)
  cfgs = [TableConfig(s, args.embedding_dim) for s in table_sizes]
  batches = []
  try:
    for bi, (_, cats_b, _) in enumerate(cal_ds):
      if bi >= n_read:
        break
      batches.append([np.asarray(c) for c in cats_b])
  finally:
    if hasattr(cal_ds, 'close'):
      cal_ds.close()
  held_out = batches[args.hot_calib_batches:]
  batches = batches[:args.hot_calib_batches]
  hot_sets = hotcache.calibrate_hot_sets(
      cfgs, cal_ids, batches, coverage=args.hot_coverage,
      budget_bytes=(int(args.hot_budget_mb * 2**20)
                    if args.hot_budget_mb else None))
  print(f'hot_cache: calibrated '
        f'{sum(h.size for h in hot_sets.values())} hot rows over '
        f'{len(hot_sets)} table(s) from {len(batches)} batch(es) '
        f'(coverage target {args.hot_coverage})')
  return hot_sets, held_out


def make_trainer(model: DLRM, trainer: str, learning_rate: float):
  """The example's trainer for ``model``: ``(step, state)``, ``step(state,
  numerical, cats, labels) -> (state, loss)`` with ``cats`` as
  ``model.dist_embedding.apply`` takes them.  Both trainers run SGD on
  the reference's warm-up + poly-decay schedule and the mean BCE (JAX
  ``examples/dlrm/main.py``): ``'sparse'`` updates the tables through
  ``SparseSGD`` and the MLPs by SGD (``make_hybrid_train_step``);
  ``'dense'`` differentiates the whole model and updates every param,
  tables included, by the same SGD (``grad.make_train_step``).  On a
  cold-tier layer the sparse step also takes ``cold_fetch=``, a
  pipelined fetch."""
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

    dense_step = grad.make_train_step(loss_fn, optimizer, dist=dist)
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
  return (lambda state, numerical, cats, labels, cold_fetch=None:
          hybrid_step(state, cats, (numerical, labels),
                      cold_fetch=cold_fetch),
          sparse.init_hybrid_train_state(dist, params, optimizer, emb_opt))


def _sync(device: torch.device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def main(argv=None):
  """Run the example; returns a dict of its numbers."""
  parser = build_parser()
  args = parser.parse_args(argv)
  refuse_unported(args, parser)

  table_sizes = [int(s) for s in args.table_sizes.split(',')]
  if args.dataset_path is not None:
    # table sizes come from the dataset (each stored less one)
    with open(os.path.join(args.dataset_path, 'model_size.json'),
              encoding='utf-8') as f:
      table_sizes = [s + 1 for s in json.load(f).values()]
  param_dtype = getattr(torch, args.param_dtype)
  hot_sets, held_out = (calibrate_hot_sets(args, table_sizes)
                        if args.hot_cache else (None, []))
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
               wire_dtype=(None if args.wire_dtype == 'none'
                           else args.wire_dtype),
               table_dtype=(None if args.table_dtype == 'none'
                            else args.table_dtype),
               param_dtype=param_dtype,
               compute_dtype=getattr(torch, args.compute_dtype
                                     or args.param_dtype),
               cold_tier=args.cold_tier_budget_mb is not None,
               device_hbm_budget=(int(args.cold_tier_budget_mb * 2**20)
                                  if args.cold_tier_budget_mb is not None
                                  else None),
               device=args.device).init(0)
  dist = model.dist_embedding
  device = dist.device
  timings = {}
  if args.cold_tier_budget_mb is not None:
    tiers = dist.plan.cold_tier_groups
    if dist.cold_tier is None:
      print(f'cold_tier: everything fits the '
            f'{args.cold_tier_budget_mb} MB/device budget — 0 tiered '
            'groups, no host tail')
    else:
      split = [(dist.plan.groups[gi].device_rows,
                dist.plan.groups[gi].tier_rows) for gi in tiers]
      print(f'cold_tier: {len(tiers)} tiered group(s); resident/tail rows '
            f'per group: {split}; host bytes '
            f'{dist.cold_tier.host_bytes():,}')
      if held_out:
        caps = coldtier.calibrate_fetch_caps(dist, held_out)
        print(f'cold_tier: fetch capacity {caps} rows per group, sized on '
              f'{len(held_out)} batch(es) held out of the hot-set '
              'calibration')
      else:
        print('cold_tier: no batch left after the hot-set calibration; '
              'the first training batch sizes the fetch capacity')
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
  if args.dataset_path is not None:
    train_dataset = open_dataset(args, table_ids, table_sizes)
    eval_dataset = open_dataset(args, table_ids, table_sizes, valid=True)
    print(f'dataset: {args.dataset_path}, {len(train_dataset)} train '
          f'batch(es), {fastloader.reader_kind(train_dataset)} reader')
  else:
    train_dataset = DummyDataset(args.batch_size,
                                 args.num_numerical_features,
                                 len(table_ids), args.num_batches)
    eval_dataset = DummyDataset(args.batch_size,
                                args.num_numerical_features,
                                len(table_ids), 10)
  if args.loader_bench:
    # the data path alone, no device work: it must outrun the trained
    # samples/s below or the loader is the bottleneck
    t0 = time.perf_counter()
    n = 0
    for _, _, labels_b in train_dataset:
      n += len(labels_b)
    dt = time.perf_counter() - t0
    timings['loader_samples_per_s'] = n / dt
    timings['loader'] = fastloader.reader_kind(train_dataset)
    print(f'loader: {n} samples in {dt:.1f}s '
          f'({n / dt / 1e6:.2f}M samples/s, no device work; '
          f'{timings["loader"]} reader)')

  step, state = make_trainer(model, args.trainer, args.learning_rate)

  # resume: one file (--load_state) or the newest VALID file of
  # --resume_dir; restore_train_state reshards the tables and sparse
  # optimizer state and restores the MLPs and both schedules' counts
  resume_step = 0
  resume_source = args.load_state or (
      args.resume_dir if args.resume_dir and os.path.isdir(args.resume_dir)
      else None)
  resumed_from = None
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
  tier_pipe = None
  if dist.cold_tier is not None:
    # the fetch pre-pass (route + dedup of the batch's tail rows) of
    # batch N+1 runs on a worker thread while the device runs batch N;
    # the payload gather stays after the previous step's write-back.
    # The batches queue in a deque, so numerical features and labels
    # stay aligned with the pipeline's (ordered) output
    tier_q = collections.deque()

    def tier_cats(it):
      for b in it:
        tier_q.append(b)
        yield [np.asarray(c) for c in b[1]]

    tier_pipe = coldtier.ColdFetchPipeline(dist, tier_cats(data_iter))

    def tier_batches():
      for cats_b, fetch in tier_pipe:
        numerical_b, _, labels_b = tier_q.popleft()
        yield numerical_b, cats_b, labels_b, fetch

    batch_iter = tier_batches()
  else:
    batch_iter = ((n, c, l, None) for n, c, l in data_iter)
  step_ms, tier_losses, tier_prepass_ms, tier_blocked_ms = [], [], [], []
  seen = {'build_ms': 0.0, 'blocked_ms': 0.0}
  for i, (numerical, cats, labels, fetch) in enumerate(batch_iter):
    t_step = time.perf_counter()
    if fetch is not None:
      state, loss = step(state, numerical, list(cats), labels,
                         cold_fetch=fetch)
    else:
      state, loss = step(state, numerical, list(cats), labels)
    if tier_pipe is not None:
      # the tiered step has synchronised (its write-back): the loss is
      # read at no extra cost
      tier_losses.append(float(loss))
      step_ms.append((time.perf_counter() - t_step) * 1000.0)
      # this batch's pre-pass and the consumer's wait for it
      now = tier_pipe.stats()
      tier_prepass_ms.append(now['build_ms'] - seen['build_ms'])
      tier_blocked_ms.append(now['blocked_ms'] - seen['blocked_ms'])
      seen = {k: now[k] for k in seen}
      if i == 0:
        tier_pipe.reset_stats()  # batch 0 has no step to hide behind
        seen = {k: 0.0 for k in seen}
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
  if tier_pipe is not None:
    tier_pipe.close()
    tstats = tier_pipe.stats()
    timings['tier_step_ms'] = step_ms
    timings['tier_prepass_ms'] = tier_prepass_ms
    timings['tier_blocked_ms'] = tier_blocked_ms
    timings['tier_losses'] = tier_losses
    timings['tier_pipeline'] = tstats
    print(f"cold_tier: fetch pre-pass built {tstats['batches']} "
          f"batch(es) in {tstats['build_ms']:.1f} ms on the worker; "
          f"consumer blocked {tstats['blocked_ms']:.1f} ms -> "
          f"{tstats['overlap_pct'] * 100:.1f}% of the host pre-pass "
          'hidden behind the device step')
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
  if args.wire_dtype != 'none':
    # the recorded legs are what the collectives shipped (docs/design.md
    # §24): the on-wire bytes beside the compute-dtype bytes
    rec = planner.reconcile_exchange(dist, journal=False)
    wb = rec['counted_wire_bytes']
    pb = rec['counted_payload_bytes']
    wired = sorted(k for k, v in rec['wire_legs'].items() if v.get('wire'))
    print(f'wire_dtype {args.wire_dtype}: narrowed leg(s) '
          f'{wired or "none"}; forward exchange ships {wb:,} bytes on '
          f'the wire vs {pb:,} at compute dtype '
          f'({pb / max(wb, 1):.2f}x fewer)')
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
