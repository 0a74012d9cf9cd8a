"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--trace forward_trace.json]

Phases, each of which exits non-zero on failure:

1. card:    name and power limit (nvidia-smi); TF32 off.
2. build:   compile every CUDA kernel from csrc/, one nvcc per source,
            all started together.
3. model:   the synthetic model at full size, tables drawn on the card.
4. kernels: the lookup kernel against its plain PyTorch version on the
            ids and tables one forward passes it (captured from that
            forward), f32 and one bf16 table; kernel, plain and library
            device times (torch.profiler) beside the device-memory
            bound.
5. forward: a few forwards at the global batch; every subgroup's lookup
            ran through the kernel; logits finite and equal to an
            independent plain reference on a slice of the batch; one
            more forward under torch.profiler (device time by kernel).
6. serving: a ServingEngine over the model's tables answers requests of
            1, 5, 64 and 4096 samples, each equal to the model's own
            lookup on the same ids.
7. train:   the model's tables, Adagrad accumulators and MLP in a
            training state (SparseAdagrad(0.01) and optax-style
            adagrad(0.01, 0.1, 1e-7), bce_with_logits: the JAX bench's
            configuration); one warm-up step, then 5 hybrid steps on
            distinct batches; every loss finite; every group's apply
            went through the segment-walk kernel and every lookup
            through the lookup kernel.
8. segwalk: the segment-walk kernel against its plain version on each
            group's update stream captured from one more real step, for
            sgd (bit-exact), adagrad_dedup and adagrad_sq (rtol = atol =
            1e-6), untouched rows unchanged, and one bf16 table; kernel
            device time over both passes (torch.profiler), plain time
            (CUDA events, one call), Tensor.index_add_ for sgd, the
            bound, the longest segment and the chunks of each stream;
            then each stream's three ops timed again in two orders (sgd
            first, and rotated), each order after one untimed warm-up
            apply.
9. profile: one training step under torch.profiler: device busy share
            and device time by kernel; one more step under torch's sync
            debug mode: its host syncs by source line.
10. dlrm:   the tiny model freed, the DLRM of examples/dlrm/main.py at
            the MLPerf Criteo-1TB table sizes (26 tables, 187,767,399
            rows x 128, bf16, about 44.8 GiB, no row cut), model-parallel
            input (dp_input=False), bf16 compute, drawn on the card;
            batches of the learnable power-law split (utils/data.py) in
            worker order.  3 forwards (one lookup launch each; the first
            512 samples equal a plain gather and the head on it); the
            lookup kernel against its plain version on the forward's ids
            (bit-exact), with embedding_bag as the library time.
11. dlrm-train: the example's trainer (SparseSGD(24) and SGD on the
            warm-up + poly-decay schedule): one warm-up step, 5 timed
            steps (one lookup and one segment-walk apply each), losses
            finite, peak memory below the card's.
12. dlrm-segwalk: one more step's sgd stream, the kernel against its
            plain version on a compact copy of the touched rows and
            against what the step wrote (bit-exact), a sample of 1 M
            untouched rows unchanged; kernel, plain and
            Tensor.index_add_ timed on the real table at lr 0 (which
            leaves it as it is, checked).
13. dlrm profile: one step under torch.profiler, one under sync debug
            mode, as in phase 9.
14. dense-tiny: the DLRM freed, the tiny model at full size again,
            trained by the dense autodiff step (grad.make_train_step:
            autograd through the lookup kernel, whose backward is the
            segment walk's 'add', then optax-style Adagrad(0.01, 0.1,
            1e-7) on every param, tables included): one warm-up step, 5
            timed steps (every loss finite, 4 lookups and 2 backward
            applies a step, peak memory below the card's); one more
            step's table gradient of every group from the kernel against
            the plain version on the same stream (bit-exact, untouched
            rows exactly zero), with the device times of the kernel's
            function (zero-fill + 'add'), its parts, the plain version
            and Tensor.index_add_ into a zero-fill, beside the bound of
            the function and that of the 'add' alone.
15. dense-dlrm: the tiny model freed, examples/dlrm/main.py --trainer
            dense's model and trainer (bf16, dp_input=False, the MLPerf
            widths, every vocabulary capped at 10 M rows: 54,063,992
            rows, 12.89 GiB) with the checks of phase 14 (1 lookup and 1
            backward apply a step), and the lookup kernel against its
            plain version on this table.
16. dense profile: right after each of phases 14 and 15, one dense step
            under torch.profiler and one under sync debug mode, as in
            phase 9.

Launches are counted per path: the forward's, the serving requests'
(counted from 0 after the engine's warm-up) and the training steps'
(counted from 0 after the warm-up step); the DLRM's forwards and
training steps likewise, and the dense steps of each model.
The line before last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits 1 and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.examples.dlrm import main as dlrm_main
from distributed_embeddings_tpu_torch.models import dlrm
from distributed_embeddings_tpu_torch.models.synthetic import (
    SYNTHETIC_MODELS, InputGenerator, SyntheticModel)
from distributed_embeddings_tpu_torch.ops import lookup, segwalk
from distributed_embeddings_tpu_torch.parallel import checkpoint, grad, sparse
from distributed_embeddings_tpu_torch.serving.engine import ServingEngine
from distributed_embeddings_tpu_torch.utils import data, nativebuild

# H100 SXM data-sheet peaks (the bound's denominators)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
KERNELS = [{
    'name': 'lookup_combine',
    'route': 'cuda',
    'source': 'distributed_embeddings_tpu_torch/csrc/lookup_combine.cu',
    'replaces': 'distributed_embeddings_tpu/ops/pallas_lookup.py:131',
}, {
    'name': 'segwalk_apply',
    'route': 'cuda',
    'source': 'distributed_embeddings_tpu_torch/csrc/segwalk_apply.cu',
    'replaces': 'distributed_embeddings_tpu/ops/pallas_segwalk.py:119',
}]
MODEL = 'tiny'
BATCH = 65536  # global batch of the forward and of training
REQUEST_SIZES = (1, 5, 64, 4096)
SERVE_BATCH = 4096
TRAIN_STEPS = 5
LR = 0.01  # the JAX bench's Keras Adagrad defaults
DLRM_ALPHA = 3.0  # examples/dlrm/gen_data.py's default skew
# the ops of the hybrid step's apply that phase 8 holds to the plain version
HYBRID_OPS = ('sgd', 'adagrad_dedup', 'adagrad_sq')
# the dense DLRM's one cut: every MLPerf vocabulary capped at 10 M rows
# (54,063,992 rows, 12.89 GiB of bf16 tables).  The dense step's peak is
# about three table-sized tensors (the tables, their table-shaped bf16
# gradient and the update ``g * -lr``); the full 44.77 GiB would need
# about 134 GiB.  Whether a larger cap fits is open (PERF.md section 7).
DENSE_DLRM_MAX_ROWS = 10_000_000


def log(*args):
  print(*args, flush=True)


def event_ms(fn, iters: int, warmup: int = 2) -> float:
  """Mean time per call of ``fn`` between two CUDA events around
  ``iters`` back-to-back calls: device time plus any gap the host leaves
  between launches."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2) -> float:
  """Mean device time per call of ``fn``: the summed duration of every
  kernel and copy it ran, from torch.profiler, over ``iters`` calls.  A
  short kernel launched from Python spends longer in the launch than on
  the device; this counts only the device.  Where the profiler records
  no device time, CUDA events time the calls instead (and say so)."""
  from torch.profiler import ProfilerActivity, profile
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
  total_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
  if total_us <= 0:
    # seen once on the card for Tensor.index_add_ on the 70.2 M-row table
    ms = event_ms(fn, iters, warmup=0)
    log(f'[timing] torch.profiler recorded no device time; CUDA events '
        f'instead: {ms:.4f} ms per call')
    return ms
  return total_us / 1e3 / iters


def phase_card():
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  # bf16 GEMMs (the DLRM phase) reduce in f32 throughout
  torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
  log(card)
  log(f'[card] torch {torch.__version__} cuda {torch.version.cuda}; '
      'tf32 off for matmul and cudnn (allow_tf32 = False); bf16 GEMMs '
      'without reduced-precision reductions')
  return card


def phase_build():
  t0 = time.perf_counter()
  with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
    built = list(pool.map(nativebuild.build, [k['name'] for k in KERNELS]))
  for b in built:
    log(f'[build] {b.name}: nvcc {b.seconds:.2f} s -> {b.path.name}')
    for line in b.log.splitlines():
      if 'registers' in line or 'spill' in line:
        log(f'[build]   {line.strip()}')
  log(f'[build] all kernels in {time.perf_counter() - t0:.2f} s '
      '(one nvcc per source, in parallel)')


def pad_multi_hot(cats, hotness, rng):
  """Variable-length multi-hot rows: each hotness > 1 row keeps a random
  prefix of 1..h ids and pads the rest with -1 (the serving layout)."""
  out = []
  for c, h in zip(cats, hotness):
    c = np.array(c, dtype=np.int32)
    if h > 1:
      keep = rng.integers(1, h + 1, size=(c.shape[0], 1))
      c[np.arange(h)[None, :] >= keep] = -1
    else:
      c = c.reshape(-1)
    out.append(c)
  return out


def captured_lookups(model, numerical, cats):
  """The (table, routed ids, combiner) of every subgroup's lookup in one
  forward (``fused_group_lookup`` calls), taken from the forward itself;
  its launches are not counted towards any path."""
  calls = []
  kernel = lookup.fused_group_lookup

  def record(table, routed, combiners, compute_dtype):
    calls.extend((table, r, c) for r, c in zip(routed, combiners))
    return kernel(table, routed, combiners, compute_dtype)

  lookup.fused_group_lookup = record
  try:
    with torch.no_grad():
      model(numerical, cats)
  finally:
    lookup.fused_group_lookup = kernel
  return calls


def check_kernel_shape(table, ids, label):
  """One kernel-vs-plain comparison and its timings at one shape."""
  m, h = ids.shape
  w = table.shape[1]
  got = lookup.dense_lookup(table, ids, 'sum', out_dtype=torch.float32)
  want = lookup.dense_lookup_reference(table, ids, 'sum', torch.float32)
  torch.cuda.synchronize()
  err = float((got - want).abs().max()) if m else 0.0
  if h == 1:
    ok = torch.equal(got, want)
    tol = 'bit-exact'
  else:
    ok = torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    tol = 'rtol=atol=1e-6 (sum order)'
  if not ok:
    raise AssertionError(f'{label}: kernel disagrees with plain version, '
                         f'max abs err {err} (tolerance {tol})')
  mask = (ids >= 0) & (ids < table.shape[0])
  safe = torch.where(mask, ids, 0).long()
  weights = mask.to(table.dtype)
  kernel = lambda: lookup.dense_lookup(table, ids, 'sum', torch.float32)
  plain = lambda: lookup.dense_lookup_reference(table, ids, 'sum',
                                                torch.float32)
  library = lambda: torch.nn.functional.embedding_bag(
      safe, table, mode='sum', per_sample_weights=weights)
  kernel_ms = device_ms(kernel, 20)
  plain_ms = device_ms(plain, 5)
  library_ms = device_ms(library, 20)
  kernel_event_ms = event_ms(kernel, 20)
  # the least bytes: each id read once, each DISTINCT row read once,
  # each output written once (a row gathered again may hit L2)
  valid = int(mask.sum())
  distinct = int(torch.unique(ids[mask]).numel())
  row_bytes = w * table.element_size()
  nbytes = m * h * 4 + distinct * row_bytes + m * w * 4
  gathered_bytes = m * h * 4 + valid * row_bytes + m * w * 4
  flops = valid * w
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  ops_ms = flops / F32_FLOP_PER_S * 1e3
  row = {
      'shape': label, 'M': m, 'h': h, 'w': w,
      'dtype': str(table.dtype).replace('torch.', ''),
      'valid_ids': valid, 'distinct_rows': distinct, 'bytes': nbytes,
      'gathered_bytes': gathered_bytes,
      'gathered_bound_ms': gathered_bytes / HBM_BYTES_PER_S * 1e3,
      'max_abs_err': err,
      'tolerance': tol, 'kernel_ms': kernel_ms, 'plain_ms': plain_ms,
      'library_ms': library_ms, 'kernel_event_ms': kernel_event_ms,
      'bound_ms': max(bytes_ms, ops_ms),
      'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
      'achieved_GBps': nbytes / (kernel_ms * 1e-3) / 1e9,
  }
  log('[kernels] ' + json.dumps(row))
  return row


def phase_kernels(model, numerical, cats):
  calls = captured_lookups(model, numerical, cats)
  if any(c != 'sum' for _, _, c in calls):
    raise AssertionError('the tiny model combines with sum only')
  label = lambda t, r: f'w{t.shape[1]}_h{r.shape[-1]}_ncap{r.shape[0]}'
  rows = [check_kernel_shape(t, r.reshape(-1, r.shape[-1]), label(t, r))
          for t, r, _ in calls]
  # one bf16 table: the widest multi-hot lookup, cast
  t, r, _ = max(calls, key=lambda c: (c[1].shape[-1], c[0].shape[1]))
  bf16_row = check_kernel_shape(t.to(torch.bfloat16),
                                r.reshape(-1, r.shape[-1]),
                                label(t, r) + '_bf16')
  return rows, bf16_row


def plain_embedding_outputs(weights, input_table_map, cats, n):
  """Independent reference of the embedding outputs for the first ``n``
  samples: gather the global tables and sum the valid rows, in f32."""
  outs = []
  for tid, c in zip(input_table_map, cats):
    t = weights[tid]
    ids = torch.as_tensor(np.asarray(c)[:n]).to(t.device).reshape(n, -1)
    mask = (ids >= 0)
    rows = t[torch.clamp(ids, 0, t.shape[0] - 1).long()].float()
    acc = torch.zeros((n, t.shape[1]), dtype=torch.float32, device=t.device)
    for j in range(ids.shape[1]):
      acc = acc + torch.where(mask[:, j, None], rows[:, j], 0.0)
    outs.append(acc)
  return outs


def phase_forward(model, numerical, cats, n_forwards=3, n_check=512):
  dist = model.dist_embedding
  n_subs = len(dist._subgroups(tuple(model.hotness)))
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  lookup.LAUNCHES = 0
  segwalk.LAUNCHES = 0
  times = []
  with torch.no_grad():
    for _ in range(n_forwards):
      t0 = time.perf_counter()
      logits = model(numerical, cats)
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
  launches = {'lookup_combine': lookup.LAUNCHES,
              'segwalk_apply': segwalk.LAUNCHES}
  if launches != {'lookup_combine': n_forwards * n_subs,
                  'segwalk_apply': 0}:
    raise AssertionError(f'forward launched {launches}, expected '
                         f'{n_forwards} x {n_subs} subgroups lookups')
  batch = np.asarray(cats[0]).shape[0]
  if tuple(logits.shape) != (batch, 1) or not bool(
      torch.isfinite(logits).all()):
    raise AssertionError(f'logits {tuple(logits.shape)} not finite or '
                         f'not [{batch}, 1]')
  # independent reference on the first n_check samples
  weights = checkpoint.get_weights(dist, model.embedding_params)
  with torch.no_grad():
    outs = dist.apply(model.embedding_params, [c[:n_check] for c in cats])
    ref = plain_embedding_outputs(weights, model.input_table_map, cats,
                                  n_check)
    for i, (o, r, h) in enumerate(zip(outs, ref, model.hotness)):
      if h == 1 and not torch.equal(o, r):
        raise AssertionError(f'input {i}: forward != plain reference')
      if h > 1 and not torch.allclose(o, r, rtol=1e-6, atol=1e-6):
        raise AssertionError(f'input {i}: forward != plain reference '
                             f'(max err {float((o - r).abs().max())})')
    ref_logits = model.head(np.asarray(numerical)[:n_check], ref)
    if not torch.allclose(logits[:n_check], ref_logits, rtol=1e-5,
                          atol=1e-5):
      raise AssertionError('logits disagree with the plain reference')
  log(f'[forward] batch {batch}: {n_forwards} forwards, ms '
      f'{[round(t, 3) for t in times]} (host clock, synchronised); '
      f'kernel launches {json.dumps(launches)}: {n_forwards} x {n_subs} '
      'subgroups')
  log(f'[forward] tables {model.total_table_gib():.3f} GiB; peak device '
      f'memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; '
      f'logits finite, first {n_check} equal the plain reference')
  return weights, launches


def profile_once(fn, tag, what, trace=None, top=10):
  """Where one call of ``fn`` spends its time: device time by kernel and
  the device's busy share of the call's wall time (torch.profiler)."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(
      activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  if trace:
    prof.export_chrome_trace(trace)
  kernels = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  if not kernels:
    log(f'[{tag}] the profiler recorded no device time: not measured')
    return
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
  log(f'[{tag}] {what}: wall {wall_ms:.3f} ms (host clock, under the '
      f'profiler); device busy {busy_ms:.3f} ms = '
      f'{100 * busy_ms / wall_ms:.1f} % of it')
  for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                  reverse=True)[:top]:
    log(f'[{tag}]   {e.self_device_time_total / 1e3:8.3f} ms '
        f'x{e.count:<4d} {e.key[:90]}')


def phase_profile(model, numerical, cats, trace=None):
  with torch.no_grad():
    profile_once(lambda: model(numerical, cats), 'profile', 'one forward',
                 trace)


def phase_serving(model, weights, cats, rng):
  dist = model.dist_embedding
  n_subs = len(dist._subgroups(tuple(model.hotness)))
  engine = ServingEngine(dist.table_configs, weights,
                         batch_size=SERVE_BATCH, device=dist.device,
                         input_table_map=model.input_table_map,
                         hotness=model.hotness)
  batch = np.asarray(cats[0]).shape[0]
  lookup.LAUNCHES = 0
  engine.warmup(sample_cats=[c[:SERVE_BATCH] for c in cats])
  warm_launches = lookup.LAUNCHES
  warm_lookups = engine.stats()['batches_served']
  lookup.LAUNCHES = 0
  segwalk.LAUNCHES = 0
  answers = []
  request_ms = {}
  for n in REQUEST_SIZES:
    times = []
    for _ in range(5):
      start = int(rng.integers(0, batch - n + 1))
      req = [c[start:start + n] for c in cats]
      t0 = time.perf_counter()
      got = engine.lookup_padded(req)
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
      answers.append((req, got))
    request_ms[n] = times
  launches = {'lookup_combine': lookup.LAUNCHES,
              'segwalk_apply': segwalk.LAUNCHES}
  lookups = engine.stats()['batches_served'] - warm_lookups
  if launches != {'lookup_combine': lookups * n_subs, 'segwalk_apply': 0}:
    raise AssertionError(f'serving launched {launches} for {lookups} '
                         f'lookups x {n_subs} subgroups')
  with torch.no_grad():
    for req, got in answers:
      want = dist.apply(model.embedding_params, req)
      for i, (g, w, h) in enumerate(zip(got, want, model.hotness)):
        same = (torch.equal(g, w) if h == 1 else
                torch.allclose(g, w, rtol=1e-6, atol=1e-6))
        if not same:
          raise AssertionError(f'request of {len(req[0])}: input {i} '
                               'differs from the model lookup')
  for n, times in request_ms.items():
    log(f'[serving] request of {n} samples: ms {[round(t, 3) for t in times]}'
        f' median {statistics.median(times):.3f} (host clock, '
        'synchronised; pad + copy + lookup)')
  log(f'[serving] stats {json.dumps(engine.stats())}')
  log(f'[serving] {len(answers)} answers equal the model lookup '
      '(bit-exact hotness 1, 1e-6 hotness 10); kernel launches '
      f'{json.dumps(launches)}: {lookups} request lookups x {n_subs} '
      f'subgroups, after {warm_launches} in the warm-up of {warm_lookups} '
      'rungs')
  return launches


def train_batches(config, hotness, seed, n):
  """``n`` distinct batches of the power-law pool, multi-hot rows
  -1-padded as in the forward: ``(cats, (numerical, labels))``."""
  rng = np.random.default_rng(seed)
  pool = InputGenerator(config, BATCH, alpha=1.05, num_batches=n,
                        seed=seed)
  return [(pad_multi_hot(cats, hotness, rng), (numerical, labels))
          for (numerical, cats), labels in pool]


def build_trainer(model):
  """The JAX bench's training configuration on the port: SparseAdagrad
  (dedup) for the tables, optax-style Adagrad for the MLP, mean BCE."""
  dist = model.dist_embedding
  dense_opt = optim.adagrad(LR, initial_accumulator_value=0.1, eps=1e-7)
  emb_opt = sparse.SparseAdagrad(learning_rate=LR)
  state = sparse.init_hybrid_train_state(
      dist, {'embedding': model.embedding_params, **model.dense_params()},
      dense_opt, emb_opt)

  def head_loss(dense_params, emb_outs, batch):
    numerical, labels = batch
    return dlrm.bce_with_logits(model.head(numerical, emb_outs,
                                           dense_params), labels)

  return sparse.make_hybrid_train_step(dist, head_loss, dense_opt,
                                       emb_opt), state


def captured_applies(step, state, cats, batch):
  """One real training step that also records each group's apply inputs
  (the table and accumulator cloned before the in-place update)."""
  calls = []
  apply = segwalk.segwalk_apply

  def record(table, acc, ids, grads, lr, *, op, eps=1e-7, g_index=None):
    calls.append({'table': table.clone(),
                  'acc': None if acc is None else acc.clone(), 'ids': ids,
                  'grads': grads, 'g_index': g_index, 'lr': lr, 'eps': eps,
                  'op': op})
    return apply(table, acc, ids, grads, lr, op=op, eps=eps,
                 g_index=g_index)

  segwalk.segwalk_apply = record
  try:
    state, loss = step(state, cats, batch)
  finally:
    segwalk.segwalk_apply = apply
  return state, loss, calls


def phase_train(model, config, seed):
  dist = model.dist_embedding
  n_groups = len(dist.plan.groups)
  n_subs = len(dist._subgroups(tuple(model.hotness)))
  # the warm-up step's batch, the counted steps', then the capture
  # step's (phase 8) and the profiled step's (phase 9)
  batches = train_batches(config, model.hotness, seed + 1, TRAIN_STEPS + 3)
  step, state = build_trainer(model)
  torch.cuda.synchronize()
  log(f'[train] state: tables {model.total_table_gib():.3f} GiB + '
      f'Adagrad accumulators; device memory '
      f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB')
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state, loss = step(state, *batches[0])
  torch.cuda.synchronize()
  log(f'[train] warm-up step (loads the kernels, allocates): '
      f'{(time.perf_counter() - t0) * 1e3:.3f} ms, loss {float(loss):.6f}')
  lookup.LAUNCHES = 0
  segwalk.LAUNCHES = 0
  times, losses = [], []
  for cats, batch in batches[1:TRAIN_STEPS + 1]:
    t0 = time.perf_counter()
    state, loss = step(state, cats, batch)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    losses.append(float(loss))
  launches = {'segwalk_apply': segwalk.LAUNCHES,
              'lookup_combine': lookup.LAUNCHES}
  if not all(np.isfinite(losses)):
    raise AssertionError(f'training losses not finite: {losses}')
  want = {'segwalk_apply': TRAIN_STEPS * n_groups,
          'lookup_combine': TRAIN_STEPS * n_subs}
  if launches != want:
    raise AssertionError(f'training launched {launches}, expected {want} '
                         f'({TRAIN_STEPS} steps x {n_groups} groups / '
                         f'{n_subs} subgroups)')
  log(f'[train] batch {BATCH}: {TRAIN_STEPS} steps, ms '
      f'{[round(t, 3) for t in times]} (host clock, synchronised); '
      f'losses {[round(x, 6) for x in losses]}')
  log(f'[train] launches {json.dumps(launches)} = {TRAIN_STEPS} steps x '
      f'({n_groups} groups, {n_subs} subgroups); peak device memory '
      f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB')
  state, loss, calls = captured_applies(step, state,
                                        *batches[TRAIN_STEPS + 1])
  if not bool(torch.isfinite(loss)):
    raise AssertionError(f'capture step loss {float(loss)} not finite')
  return step, state, calls, batches[-1], launches


def segwalk_bound(segs, m, table, acc, op):
  """``(bytes, bound_ms, bound_by)`` of one apply: each position's id
  and gradient-row index read once, each compact f32 gradient row read
  once, each touched table (and accumulator) row read and written once;
  f32 operations per summed element and per updated element."""
  n, u, w = segs.sorted_ids.shape[0], segs.count, table.shape[1]
  valid = int((segs.ends - segs.starts).sum())
  row_rw = 2 * w * (table.element_size() + (4 if acc is not None else 0))
  nbytes = n * 4 + n * 4 + m * w * 4 + u * row_rw
  flops = valid * w * (1 if op != 'adagrad_sq' else 3) + u * w * 6
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  ops_ms = flops / F32_FLOP_PER_S * 1e3
  return (nbytes, max(bytes_ms, ops_ms),
          'bytes' if bytes_ms >= ops_ms else 'operations')


def check_segwalk(call, op, table, label):
  """Kernel against plain version on one captured stream (clones of its
  table and accumulator), with the timings and the bound."""
  lr, eps = call['lr'], call['eps']
  acc = None if op == 'sgd' else call['acc']
  ids, grads, g_index = call['ids'], call['grads'], call['g_index']
  rows, w = table.shape
  segs = segwalk.sort_stream(ids, rows, g_index)
  kt = table.clone()
  ka = None if acc is None else acc.clone()
  segwalk.apply_segments(kt, ka, segs, grads, lr, op=op, eps=eps)
  pt = table.clone()
  pa = None if acc is None else acc.clone()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  segwalk.apply_segments_reference(pt, pa, segs, grads, lr, op=op, eps=eps)
  end.record()
  end.synchronize()
  plain_ms = start.elapsed_time(end)
  err = float((kt.float() - pt.float()).abs().max())
  if acc is not None:
    err = max(err, float((ka - pa).abs().max()))
  if op == 'sgd':
    ok, tol = torch.equal(kt, pt), 'bit-exact'
  else:
    ok = (torch.allclose(kt.float(), pt.float(), rtol=1e-6, atol=1e-6)
          and torch.allclose(ka, pa, rtol=1e-6, atol=1e-6))
    tol = 'rtol=atol=1e-6 (rsqrt)'
  if not ok:
    raise AssertionError(f'{label}: kernel disagrees with plain version, '
                         f'max abs err {err} (tolerance {tol})')
  # rows the stream does not name stay bitwise unchanged
  touched = torch.zeros(rows, dtype=torch.bool, device=table.device)
  touched[segs.sorted_ids[segs.starts].long()] = True
  changed = (kt != table).any(dim=1)
  if acc is not None:
    changed |= (ka != acc).any(dim=1)
  if bool((changed & ~touched).any()):
    raise AssertionError(f'{label}: the kernel changed rows outside the '
                         'stream')
  del pt, pa
  kernel_ms = device_ms(
      lambda: segwalk.apply_segments(kt, ka, segs, grads, lr, op=op,
                                     eps=eps), 10)
  library_ms = None
  if op == 'sgd':
    # Tensor.index_add_: the one PyTorch call computing the sgd apply
    lo, hi = int(segs.starts[0]), int(segs.ends[-1])
    lib_ids = segs.sorted_ids[lo:hi].long()
    lib_g = grads[segs.gidx[lo:hi].long()]
    library_ms = device_ms(
        lambda: kt.index_add_(0, lib_ids, lib_g.to(kt.dtype), alpha=-lr), 10)
    del lib_ids, lib_g
  n, m, u = ids.shape[0], grads.shape[0], segs.count
  valid = int((segs.ends - segs.starts).sum())
  nbytes, bound_ms, bound_by = segwalk_bound(segs, m, table, acc, op)
  row = {
      'stream': label, 'op': op,
      'dtype': str(table.dtype).replace('torch.', ''), 'rows': rows,
      'w': w, 'positions': n, 'valid_positions': valid,
      'compact_grad_rows': m, 'segments': u,
      'longest_segment': segs.longest(), 'chunk': segwalk.CHUNK,
      'chunks': -(-n // segwalk.CHUNK), 'bytes': nbytes,
      'max_abs_err': err, 'tolerance': tol, 'kernel_ms': kernel_ms,
      'plain_ms': plain_ms, 'library_ms': library_ms,
      'bound_ms': bound_ms, 'bound_by': bound_by,
      'achieved_GBps': nbytes / (kernel_ms * 1e-3) / 1e9,
  }
  log('[segwalk] ' + json.dumps(row))
  del kt, ka
  torch.cuda.empty_cache()
  return row


def order_timings(call, label, order):
  """Kernel device time of each op in ``order`` on one captured stream,
  one after the other on the same clones, after one untimed warm-up
  apply of the first."""
  segs = segwalk.sort_stream(call['ids'], call['table'].shape[0],
                             call['g_index'])
  kt, ka = call['table'].clone(), call['acc'].clone()

  def apply(op):
    segwalk.apply_segments(kt, None if op == 'sgd' else ka, segs,
                           call['grads'], call['lr'], op=op, eps=call['eps'])

  apply(order[0])
  torch.cuda.synchronize()
  times = {op: device_ms(lambda: apply(op), 10, warmup=0) for op in order}
  log(f'[segwalk] {label} order {" -> ".join(order)}: kernel ms '
      f'{json.dumps(times)}')
  del kt, ka
  torch.cuda.empty_cache()
  return times


def phase_segwalk(calls):
  rows = []
  for call in calls:
    label = f'w{call["table"].shape[1]}_rows{call["table"].shape[0]}'
    if call['op'] != 'adagrad_dedup':
      raise AssertionError(f'the training path applies adagrad_dedup, '
                           f'captured {call["op"]}')
    for op in HYBRID_OPS:
      rows.append(check_segwalk(call, op, call['table'], label))
    # is an op's time a matter of its place in the sequence?
    for order in (HYBRID_OPS, HYBRID_OPS[1:] + HYBRID_OPS[:1]):
      order_timings(call, label, order)
  # one bf16 table: the largest group's, cast
  call = max(calls, key=lambda c: c['table'].numel())
  label = f'w{call["table"].shape[1]}_rows{call["table"].shape[0]}_bf16'
  bf16_row = check_segwalk(call, 'adagrad_dedup',
                           call['table'].to(torch.bfloat16), label)
  for r in rows + [bf16_row]:
    log(f'[segwalk] {r["stream"]} {r["op"]} {r["dtype"]}: kernel '
        f'{r["kernel_ms"]:.4f} ms, plain {r["plain_ms"]:.3f} ms (one '
        f'call), library {r["library_ms"]}, bound {r["bound_ms"]:.4f} ms; '
        f'{r["segments"]} segments, longest {r["longest_segment"]}, '
        f'{r["chunks"]} chunks of {r["chunk"]}')
  log('[segwalk] Tensor.index_add_ is the library time for sgd; no '
      'PyTorch call computes the Adagrad applies (library null)')
  return rows, bf16_row


def host_syncs(fn):
  """The host syncs of one call of ``fn`` that torch's sync debug mode
  sees (a prototype: it does not see every synchronising operation), by
  the Python line that made them."""
  torch.cuda.synchronize()
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    torch.cuda.set_sync_debug_mode('warn')
    try:
      fn()
    finally:
      torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  return collections.Counter(
      f'{pathlib.Path(w.filename).name}:{w.lineno}' for w in caught
      if 'called a synchronizing' in str(w.message))


def phase_train_profile(step, state, batch):
  losses = []
  profile_once(lambda: losses.append(step(state, *batch)[1]),
               'profile-train', 'one training step', top=20)
  syncs = host_syncs(lambda: losses.append(step(state, *batch)[1]))
  if not all(bool(torch.isfinite(x)) for x in losses):
    raise AssertionError('profiled step loss not finite')
  log(f'[profile-train] host syncs in one more step (sync debug mode): '
      f'{sum(syncs.values())}, by line '
      f'{json.dumps(dict(syncs.most_common()))}')


def dlrm_batches(model, seed, n):
  """``n`` batches of the learnable power-law split at the model's
  vocabularies (``utils.data.generate_split``, alpha 3.0, 13 numerical
  features), the categorical inputs in worker order: ``(cats,
  (numerical, labels))``."""
  rng = np.random.default_rng(seed)
  plan = model.dist_embedding.plan
  order = [i for dev in plan.input_ids_list for i in dev]
  return [([cats[i].astype(np.int32) for i in order],
           (numerical.astype(np.float32),
            labels.astype(np.float32)[:, None]))
          for labels, numerical, cats in data.generate_split(
              rng, model.table_sizes, n * BATCH, DLRM_ALPHA, 13,
              chunk=BATCH)]


def input_order(model, cats):
  """Worker-order inputs back in input order."""
  order = [i for dev in model.dist_embedding.plan.input_ids_list
           for i in dev]
  pos = {i: k for k, i in enumerate(order)}
  return [cats[pos[i]] for i in range(len(order))]


def phase_dlrm_model(seed):
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  model = dlrm.DLRM(data.MLPERF_SIZES, embedding_dim=128,
                    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                    dp_input=False, dist_strategy='memory_balanced',
                    device='cuda').init(seed)
  torch.cuda.synchronize()
  dist = model.dist_embedding
  log(f'[dlrm] {len(data.MLPERF_SIZES)} tables at the MLPerf Criteo-1TB '
      f'sizes, {sum(data.MLPERF_SIZES):,} rows x 128, bf16: '
      f'{model.total_table_gib():.3f} GiB, drawn on the card in '
      f'{time.perf_counter() - t0:.2f} s; device memory '
      f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, peak '
      f'{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB during the '
      'draw')
  log(f'[dlrm] plan: {len(dist.plan.groups)} group(s) '
      f'{[(g.width, g.rows_cap, g.combiner) for g in dist.plan.groups]} '
      '(width, rows_cap, combiner); dp_input=False, bf16 compute; MLPs '
      f'{model.bottom_mlp.dims} and {model.top_mlp.dims}')
  return model


def phase_dlrm_forward(model, numerical, cats, n_forwards=3, n_check=512):
  """The example model's forward in model-parallel input mode: one
  lookup launch per forward; the first ``n_check`` samples' embedding
  outputs equal an independent gather bit for bit, and their logits the
  head's on those outputs."""
  dist = model.dist_embedding
  lookup.LAUNCHES = 0
  segwalk.LAUNCHES = 0
  times = []
  with torch.no_grad():
    for _ in range(n_forwards):
      t0 = time.perf_counter()
      logits = model(numerical, cats)
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
  launches = {'lookup_combine': lookup.LAUNCHES,
              'segwalk_apply': segwalk.LAUNCHES}
  if launches != {'lookup_combine': n_forwards, 'segwalk_apply': 0}:
    raise AssertionError(f'dlrm forward launched {launches}, expected '
                         f'{n_forwards} lookups')
  if tuple(logits.shape) != (BATCH, 1) or not bool(
      torch.isfinite(logits).all()):
    raise AssertionError(f'dlrm logits {tuple(logits.shape)} not finite '
                         f'or not [{BATCH}, 1]')
  weights = checkpoint.get_weights(dist, model.embedding_params)
  head = [c[:n_check] for c in cats]
  with torch.no_grad():
    outs = dist.apply(model.embedding_params, head)
    ref = plain_embedding_outputs(weights, dist.plan.input_table_map,
                                  input_order(model, head), n_check)
    for i, (o, r) in enumerate(zip(outs, ref)):
      if not torch.equal(o.float(), r.to(o.dtype).float()):
        raise AssertionError(f'dlrm input {i}: forward != plain gather')
    ref_logits = model.head(model.dense_params(), numerical[:n_check],
                            [r.to(torch.bfloat16) for r in ref])
    if not torch.equal(model(numerical[:n_check], head), ref_logits):
      raise AssertionError('dlrm logits disagree with the head on the '
                           'plain gather')
    # the same samples inside the full batch: other GEMM shapes, bf16
    err = float((logits[:n_check] - ref_logits).abs().max())
    if not torch.allclose(logits[:n_check], ref_logits, rtol=2e-2,
                          atol=2e-2):
      raise AssertionError(f'dlrm batch logits off the slice by {err}')
  log(f'[dlrm] forward, batch {BATCH}: ms {[round(t, 3) for t in times]} '
      f'(host clock, synchronised); launches {json.dumps(launches)}; '
      f'logits finite; first {n_check} samples equal a plain gather and '
      f'the head on it, within {err:.3g} of the full batch (bf16 GEMMs '
      'at another shape; bound 2e-2)')
  return launches


def dlrm_trainer(model):
  """``examples/dlrm/main.py``'s sparse trainer (SparseSGD(24) on the
  tables, SGD on the MLPs, both on the warm-up + poly-decay schedule,
  mean BCE), called as ``step(state, cats, (numerical, labels))``."""
  step, state = dlrm_main.make_trainer(model, 'sparse', 24.0)
  return (lambda state, cats, batch: step(state, batch[0], cats, batch[1]),
          state)


def phase_dlrm_train(model, batches):
  step, state = dlrm_trainer(model)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state, loss = step(state, *batches[0])
  torch.cuda.synchronize()
  log(f'[dlrm-train] warm-up step: {(time.perf_counter() - t0) * 1e3:.3f} '
      f'ms, loss {float(loss):.6f}')
  lookup.LAUNCHES = 0
  segwalk.LAUNCHES = 0
  times, losses = [], []
  for cats, batch in batches[1:TRAIN_STEPS + 1]:
    t0 = time.perf_counter()
    state, loss = step(state, cats, batch)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    losses.append(float(loss))
  launches = {'lookup_combine': lookup.LAUNCHES,
              'segwalk_apply': segwalk.LAUNCHES}
  if not all(np.isfinite(losses)):
    raise AssertionError(f'dlrm training losses not finite: {losses}')
  want = {'lookup_combine': TRAIN_STEPS, 'segwalk_apply': TRAIN_STEPS}
  if launches != want:
    raise AssertionError(f'dlrm training launched {launches}, expected '
                         f'{want}')
  peak = torch.cuda.max_memory_allocated()
  total = torch.cuda.get_device_properties(0).total_memory
  if peak >= total:
    raise AssertionError(f'peak {peak} B above the card\'s {total} B')
  med = statistics.median(times)
  log(f'[dlrm-train] batch {BATCH}: {TRAIN_STEPS} steps, ms '
      f'{[round(t, 3) for t in times]} (host clock, synchronised), median '
      f'{med:.3f} = {BATCH / med * 1e3:,.0f} samples/s; losses '
      f'{[round(x, 6) for x in losses]}')
  log(f'[dlrm-train] launches {json.dumps(launches)} = {TRAIN_STEPS} steps '
      f'x 1; peak device memory {peak / 2**30:.3f} GiB of the card\'s '
      f'{total / 2**30:.3f} GiB')
  return step, state, launches, times


def captured_dlrm_apply(step, state, cats, batch, n_sample=1 << 20):
  """One real training step that also records its apply: the stream, and
  before the in-place update a compact copy of the rows it touches and a
  sample of ``n_sample`` rows it does not (the 48 GB table is never
  cloned)."""
  calls = []
  apply = segwalk.segwalk_apply

  def record(table, acc, ids, grads, lr, *, op, eps=1e-7, g_index=None):
    rows = table.shape[0]
    touched = torch.unique(ids[(ids >= 0) & (ids < rows)])
    gen = torch.Generator(device=table.device).manual_seed(0)
    sample = torch.randint(0, rows, (n_sample,), device=table.device,
                           generator=gen, dtype=torch.int64)
    sample = sample[~torch.isin(sample, touched.long())]
    calls.append({'table': table, 'ids': ids, 'grads': grads,
                  'g_index': g_index, 'lr': lr, 'eps': eps, 'op': op,
                  'touched': touched, 'compact': table[touched.long()],
                  'sample': sample, 'before': table[sample]})
    return apply(table, acc, ids, grads, lr, op=op, eps=eps,
                 g_index=g_index)

  segwalk.segwalk_apply = record
  try:
    state, loss = step(state, cats, batch)
  finally:
    segwalk.segwalk_apply = apply
  return state, loss, calls


def check_dlrm_segwalk(call):
  """The captured sgd stream: the kernel against its plain version on a
  compact copy of the touched rows (ids remapped in order, so the sorted
  stream and its summation order are the same), both against what the
  step wrote into the real table (bit-exact); the sampled untouched rows
  unchanged.  Kernel, plain and ``Tensor.index_add_`` timed on the real
  table at lr 0, which leaves it bitwise as it is (checked)."""
  table, ids, grads, lr = call['table'], call['ids'], call['grads'], \
      call['lr']
  touched, g_index = call['touched'], call['g_index']
  rows, w = table.shape
  if call['op'] != 'sgd':
    raise AssertionError(f'the DLRM step applies sgd, captured {call["op"]}')
  if not torch.equal(table[call['sample']], call['before']):
    raise AssertionError('dlrm: the step changed rows outside its stream')
  stepped = table[touched.long()]
  u = touched.shape[0]
  valid = (ids >= 0) & (ids < rows)
  cids = torch.where(valid, torch.searchsorted(touched, ids).to(torch.int32),
                     torch.full_like(ids, u))
  csegs = segwalk.sort_stream(cids, u, g_index)
  kt, pt = call['compact'].clone(), call['compact'].clone()
  segwalk.apply_segments(kt, None, csegs, grads, lr, op='sgd')
  segwalk.apply_segments_reference(pt, None, csegs, grads, lr, op='sgd')
  torch.cuda.synchronize()
  err = float((kt.float() - pt.float()).abs().max())
  if not (torch.equal(kt, pt) and torch.equal(stepped, pt)):
    raise AssertionError(f'dlrm sgd: kernel, plain version and the step '
                         f'disagree, max abs err {err} (bit-exact)')
  del kt, pt
  segs = segwalk.sort_stream(ids, rows, g_index)
  kernel = lambda: segwalk.apply_segments(table, None, segs, grads, 0.0,
                                          op='sgd')
  kernel_ms = device_ms(kernel, 10)
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  segwalk.apply_segments_reference(table, None, segs, grads, 0.0, op='sgd')
  end.record()
  end.synchronize()
  plain_ms = start.elapsed_time(end)
  lo, hi = int(segs.starts[0]), int(segs.ends[-1])
  lib_ids = segs.sorted_ids[lo:hi].long()
  lib_g = grads[segs.gidx[lo:hi].long()].to(table.dtype)
  library_ms = device_ms(lambda: table.index_add_(0, lib_ids, lib_g,
                                                  alpha=-0.0), 10)
  del lib_ids, lib_g
  if not (torch.equal(table[touched.long()], stepped)
          and torch.equal(table[call['sample']], call['before'])):
    raise AssertionError('dlrm: an apply at lr 0 changed the table')
  n, m = ids.shape[0], grads.shape[0]
  nbytes, bound_ms, bound_by = segwalk_bound(segs, m, table, None, 'sgd')
  row = {
      'stream': f'w{w}_rows{rows}', 'op': 'sgd',
      'dtype': str(table.dtype).replace('torch.', ''), 'rows': rows, 'w': w,
      'positions': n, 'valid_positions': int((segs.ends - segs.starts).sum()),
      'compact_grad_rows': m, 'segments': u,
      'longest_segment': segs.longest(), 'chunk': segwalk.CHUNK,
      'chunks': -(-n // segwalk.CHUNK), 'bytes': nbytes,
      'max_abs_err': err, 'tolerance': 'bit-exact',
      'kernel_ms': kernel_ms, 'plain_ms': plain_ms, 'library_ms': library_ms,
      'bound_ms': bound_ms, 'bound_by': bound_by,
      'achieved_GBps': nbytes / (kernel_ms * 1e-3) / 1e9,
      'untouched_rows_sampled': int(call['sample'].shape[0]),
  }
  log('[dlrm-segwalk] ' + json.dumps(row))
  torch.cuda.empty_cache()
  return row


def run_dlrm(seed, tiny_k, tiny_seg):
  """The DLRM phases: the example's model at the MLPerf table sizes in
  bf16, forward, kernels, training, the apply check and a profile.
  Adds a ``dlrm`` entry to each kernel's summary."""
  model = phase_dlrm_model(seed)
  # the forwards', the warm-up's, the timed steps', the capture step's
  # and the profiled steps' batches
  t0 = time.perf_counter()
  batches = dlrm_batches(model, seed + 2, TRAIN_STEPS + 4)
  log(f'[dlrm] {len(batches)} batches of {BATCH} drawn on the host in '
      f'{time.perf_counter() - t0:.2f} s (alpha {DLRM_ALPHA})')
  cats, (numerical, _) = batches[0]
  fwd_launches = phase_dlrm_forward(model, numerical, cats)
  (table, routed, combiner), = captured_lookups(model, numerical, cats)
  if combiner is not None:
    raise AssertionError(f'the DLRM tables combine with None, got '
                         f'{combiner}')
  lk = check_kernel_shape(table, routed.reshape(-1, 1),
                          f'dlrm_w128_h1_ncap{routed.shape[0]}_bf16')
  del table, routed
  step, state, launches, step_ms = phase_dlrm_train(model, batches[1:])
  state, loss, calls = captured_dlrm_apply(step, state,
                                           *batches[TRAIN_STEPS + 2])
  if not bool(torch.isfinite(loss)) or len(calls) != 1:
    raise AssertionError(f'capture step: loss {float(loss)}, '
                         f'{len(calls)} applies')
  sw = check_dlrm_segwalk(calls[0])
  del calls
  torch.cuda.empty_cache()
  phase_train_profile(step, state, batches[TRAIN_STEPS + 3])

  shape = lambda r, keys: {k: r[k] for k in keys}
  tiny_k['dlrm'] = {
      'launches': launches['lookup_combine'],
      'launches_forward': fwd_launches['lookup_combine'],
      'shape': shape(lk, ('M', 'h', 'w', 'dtype', 'distinct_rows')),
      'table_rows': sum(data.MLPERF_SIZES),
      'max_abs_err': lk['max_abs_err'], 'ms': lk['kernel_ms'],
      'plain_ms': lk['plain_ms'], 'bound_ms': lk['bound_ms'],
      'bound_by': lk['bound_by'], 'library_ms': lk['library_ms'],
  }
  tiny_seg['dlrm'] = {
      'launches': launches['segwalk_apply'],
      'launches_forward': fwd_launches['segwalk_apply'],
      'shape': shape(sw, ('op', 'dtype', 'rows', 'w', 'positions',
                          'segments', 'longest_segment', 'chunks')),
      'max_abs_err': sw['max_abs_err'], 'ms': sw['kernel_ms'],
      'plain_ms': sw['plain_ms'], 'bound_ms': sw['bound_ms'],
      'bound_by': sw['bound_by'], 'library_ms': sw['library_ms'],
  }
  log(f'[dlrm] lookup {lk["kernel_ms"]:.4f} ms (bound '
      f'{lk["bound_ms"]:.4f}, plain {lk["plain_ms"]:.3f}, embedding_bag '
      f'{lk["library_ms"]:.4f}); segment walk sgd {sw["kernel_ms"]:.4f} '
      f'ms (bound {sw["bound_ms"]:.4f}, plain {sw["plain_ms"]:.3f}, '
      f'index_add_ {sw["library_ms"]:.4f}); steps {step_ms}')


def captured_backward(step, state, *batch):
  """One real dense step that also records its lookup backwards (the
  arguments of every ``lookup.lookup_grad`` call: one per fusion
  group)."""
  calls = []
  fn = lookup.lookup_grad

  def record(ids, grads, combiners, vocab, dtype):
    calls.append({'ids': ids, 'grads': grads, 'combiners': combiners,
                  'vocab': vocab, 'dtype': dtype})
    return fn(ids, grads, combiners, vocab, dtype)

  lookup.lookup_grad = record
  try:
    state, loss = step(state, *batch)
  finally:
    lookup.lookup_grad = fn
  return state, loss, calls


# rows per block of the checks on table-shaped gradients, which make no
# table-sized temporary (the DLRM's is 12.9 GiB)
CHECK_BLOCK_ROWS = 1 << 22


def untouched_rows_zero(grad_table, touched):
  """Whether every row outside ``touched`` (a bool mask over the rows)
  is exactly zero."""
  for r0 in range(0, grad_table.shape[0], CHECK_BLOCK_ROWS):
    nonzero = (grad_table[r0:r0 + CHECK_BLOCK_ROWS] != 0).any(dim=1)
    if bool((nonzero & ~touched[r0:r0 + CHECK_BLOCK_ROWS]).any()):
      return False
  return True


def compare_tables(a, b):
  """``(equal, max abs difference)`` of two table-shaped tensors."""
  same, err = True, 0.0
  for r0 in range(0, a.shape[0], CHECK_BLOCK_ROWS):
    x, y = a[r0:r0 + CHECK_BLOCK_ROWS], b[r0:r0 + CHECK_BLOCK_ROWS]
    same = same and torch.equal(x, y)
    err = max(err, float((x.float() - y.float()).abs().max()))
  return same, err


def check_dense_grad(call, label):
  """The lookup's backward on one group's captured stream: the table
  gradient from the kernel (a zero-fill, then the segment walk's
  'add') against the plain version (bit-exact), untouched rows exactly
  zero; device times of the kernel's function, of its two parts, of the
  plain version (one call) and of ``Tensor.index_add_`` into a zero-fill
  (the library), beside the function's bound and the 'add''s own."""
  vocab, dtype = call['vocab'], call['dtype']
  segs, rows = lookup.grad_stream(call['ids'], call['grads'],
                                  call['combiners'], vocab)
  w = rows.shape[1]
  dev = rows.device

  def kernel():
    out = torch.zeros((vocab, w), dtype=dtype, device=dev)
    segwalk.apply_segments(out, None, segs, rows, 0.0, op='add')
    return out

  kt = kernel()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  pt = torch.zeros((vocab, w), dtype=dtype, device=dev)
  segwalk.apply_segments_reference(pt, None, segs, rows, 0.0, op='add')
  end.record()
  end.synchronize()
  plain_ms = start.elapsed_time(end)
  same, err = compare_tables(kt, pt)
  if not same:
    raise AssertionError(f'{label}: the backward kernel disagrees with the '
                         f'plain version, max abs err {err} (bit-exact)')
  del pt
  touched = torch.zeros(vocab, dtype=torch.bool, device=dev)
  touched[segs.sorted_ids[segs.starts].long()] = True
  if not untouched_rows_zero(kt, touched):
    raise AssertionError(f'{label}: a row no id names has a gradient')
  add_ms = device_ms(lambda: segwalk.apply_segments(kt, None, segs, rows,
                                                    0.0, op='add'), 10)
  zero_ms = device_ms(kt.zero_, 10)
  del kt
  kernel_ms = device_ms(kernel, 10)
  lo, hi = int(segs.starts[0]), int(segs.ends[-1])
  lib_ids = segs.sorted_ids[lo:hi].long()
  lib_rows = rows[segs.gidx[lo:hi].long()].to(dtype)
  library_ms = device_ms(
      lambda: torch.zeros((vocab, w), dtype=dtype, device=dev).index_add_(
          0, lib_ids, lib_rows), 10)
  del lib_ids, lib_rows
  # the least bytes of the function: the stream's ids and row map and
  # its cotangent rows read once, the gradient written once; one f32 add
  # per valid element.  The 'add' alone reads and writes only the
  # touched rows, and adds each segment's sum into its row.
  n, m, u = segs.sorted_ids.shape[0], rows.shape[0], segs.count
  valid = int((segs.ends - segs.starts).sum())
  itemsize = torch.empty((), dtype=dtype).element_size()
  stream_bytes = n * 4 + n * 4 + m * w * 4
  nbytes = stream_bytes + vocab * w * itemsize
  add_bytes = stream_bytes + 2 * u * w * itemsize
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  ops_ms = valid * w / F32_FLOP_PER_S * 1e3
  add_bytes_ms = add_bytes / HBM_BYTES_PER_S * 1e3
  add_ops_ms = (valid + u) * w / F32_FLOP_PER_S * 1e3
  row = {
      'stream': label, 'op': 'add', 'dtype': str(dtype).replace('torch.', ''),
      'rows': vocab, 'w': w, 'positions': n, 'valid_positions': valid,
      'cotangent_rows': m, 'segments': u, 'longest_segment': segs.longest(),
      'chunks': -(-n // segwalk.CHUNK), 'bytes': nbytes, 'max_abs_err': err,
      'tolerance': 'bit-exact', 'kernel_ms': kernel_ms, 'add_ms': add_ms,
      'zero_fill_ms': zero_ms, 'plain_ms': plain_ms,
      'library_ms': library_ms, 'bound_ms': max(bytes_ms, ops_ms),
      'bound_by': 'bytes' if bytes_ms >= ops_ms else 'operations',
      'add_bytes': add_bytes, 'add_bound_ms': max(add_bytes_ms, add_ops_ms),
      'add_bound_by': 'bytes' if add_bytes_ms >= add_ops_ms else 'operations',
  }
  log('[dense-grad] ' + json.dumps(row))
  torch.cuda.empty_cache()
  return row


def phase_dense(tag, step, state, batches, per_step):
  """Phase 14 or 15: one warm-up dense step, ``TRAIN_STEPS`` timed ones
  (every loss finite, every lookup on the lookup kernel and every
  backward on the segment walk, ``per_step`` launches of each a step,
  peak memory below the card's), then one captured step whose table
  gradient of every group ``check_dense_grad`` holds to the plain
  version, then phase 16's profile and host syncs of one more step."""
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  state, loss = step(state, *batches[0])
  torch.cuda.synchronize()
  log(f'[{tag}] warm-up step: {(time.perf_counter() - t0) * 1e3:.3f} ms, '
      f'loss {float(loss):.6f}')
  lookup.LAUNCHES = 0
  segwalk.LAUNCHES = 0
  times, losses = [], []
  for batch in batches[1:TRAIN_STEPS + 1]:
    t0 = time.perf_counter()
    state, loss = step(state, *batch)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    losses.append(float(loss))
  launches = {'lookup_combine': lookup.LAUNCHES,
              'segwalk_apply': segwalk.LAUNCHES}
  if not all(np.isfinite(losses)):
    raise AssertionError(f'{tag}: losses not finite: {losses}')
  want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
  if launches != want:
    raise AssertionError(f'{tag}: launched {launches}, expected {want}')
  peak = torch.cuda.max_memory_allocated()
  total = torch.cuda.get_device_properties(0).total_memory
  if peak >= total:
    raise AssertionError(f'{tag}: peak {peak} B above the card\'s {total} B')
  med = statistics.median(times)
  log(f'[{tag}] batch {BATCH}: {TRAIN_STEPS} dense steps, ms '
      f'{[round(t, 3) for t in times]} (host clock, synchronised), median '
      f'{med:.3f} = {BATCH / med * 1e3:,.0f} samples/s; losses '
      f'{[round(x, 6) for x in losses]}')
  log(f'[{tag}] launches {json.dumps(launches)} = {TRAIN_STEPS} steps x '
      f'{json.dumps(per_step)} (every forward lookup on lookup_combine, '
      f'every backward on segwalk_apply \'add\'); peak device memory '
      f'{peak / 2**30:.3f} GiB of the card\'s {total / 2**30:.3f} GiB')
  state, loss, calls = captured_backward(step, state,
                                         *batches[TRAIN_STEPS + 1])
  if not bool(torch.isfinite(loss)) or len(calls) != per_step['segwalk_apply']:
    raise AssertionError(f'{tag}: capture step loss {float(loss)}, '
                         f'{len(calls)} backwards')
  grad_rows = []
  while calls:
    call = calls.pop(0)
    w = call['grads'][0].shape[1]
    grad_rows.append(check_dense_grad(call, f'{tag}_rows{call["vocab"]}_w{w}'))
    del call
  torch.cuda.empty_cache()
  # phase 16: the profile and the host syncs of one more step each
  losses = []
  profile_once(lambda: losses.append(step(state, *batches[-1])[1]),
               'dense-profile', f'{tag}: one dense step', top=20)
  syncs = host_syncs(lambda: losses.append(step(state, *batches[-1])[1]))
  if not all(bool(torch.isfinite(x)) for x in losses):
    raise AssertionError(f'{tag}: profiled step loss not finite')
  log(f'[dense-profile] {tag}: host syncs in one more step (sync debug '
      f'mode): {sum(syncs.values())}, by line '
      f'{json.dumps(dict(syncs.most_common()))}')
  return launches, grad_rows, peak, times


def dense_entry(launches, rows, keys, extra=None):
  """A kernel's ``dense`` entry of the summary line for one model: the
  times and bounds summed over ``rows`` (one per stream of a step), and
  each stream's ``keys``."""
  entry = {'launches': launches,
           'streams': [{k: r[k] for k in keys} for r in rows],
           'max_abs_err': max(r['max_abs_err'] for r in rows)}
  for k in ('ms', 'plain_ms', 'library_ms', 'bound_ms'):
    entry[k] = sum(r['kernel_ms' if k == 'ms' else k] for r in rows)
  entry['bound_by'] = ('bytes' if all(r['bound_by'] == 'bytes' for r in rows)
                       else 'operations')
  entry.update(extra or {})
  return entry


# each backward stream's shape and parts in the summary line
DENSE_GRAD_KEYS = ('stream', 'op', 'dtype', 'rows', 'w', 'positions',
                   'segments', 'longest_segment', 'add_ms', 'add_bound_ms',
                   'zero_fill_ms')


def run_dense_tiny(seed, lookup_k):
  """Phase 14 (and 16): the tiny model at full size trained by the dense
  autodiff step with dense Adagrad on every param (``optim.adagrad(0.01,
  0.1, 1e-7)``, mean BCE, ``dp_input=True``); returns the two kernels'
  ``dense`` entries for it.  ``lookup_k``: the lookup's summary from
  phase 4, whose shapes are this model's lookups'."""
  config = SYNTHETIC_MODELS[MODEL]
  model = SyntheticModel(config, dp_input=True, device='cuda').init(seed)
  dist = model.dist_embedding
  opt = optim.adagrad(LR, initial_accumulator_value=0.1, eps=1e-7)

  def loss_fn(params, batch):
    cats, (numerical, labels) = batch
    return dlrm.bce_with_logits(model.apply(params, numerical, cats), labels)

  step = grad.make_train_step(loss_fn, opt)
  state = grad.init_train_state(
      {'embedding': model.embedding_params, **model.dense_params()}, opt)
  torch.cuda.synchronize()
  log(f'[dense-tiny] tables {model.total_table_gib():.3f} GiB f32 + '
      f'Adagrad sum of squares on every param; device memory '
      f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB')
  batches = [(batch,) for batch in train_batches(
      config, model.hotness, seed + 3, TRAIN_STEPS + 3)]
  per_step = {'lookup_combine': len(dist._subgroups(tuple(model.hotness))),
              'segwalk_apply': len(dist.plan.groups)}
  launches, rows, peak, times = phase_dense('dense-tiny', step, state,
                                            batches, per_step)
  k = {'launches': launches['lookup_combine'],
       'shape': 'the forward\'s, timed in phase 4',
       **{key: lookup_k[key] for key in ('max_abs_err', 'ms', 'plain_ms',
                                         'library_ms', 'bound_ms',
                                         'bound_by')},
       'step_ms': times, 'peak_gib': peak / 2**30}
  seg = dense_entry(launches['segwalk_apply'], rows, DENSE_GRAD_KEYS)
  return k, seg


def run_dense_dlrm(seed):
  """Phase 15 (and 16): the DLRM of ``examples/dlrm/main.py --trainer
  dense`` (bf16, ``dp_input=False``, the MLPerf widths, every vocabulary
  capped at ``DENSE_DLRM_MAX_ROWS``) through the example's trainer;
  returns the two kernels' ``dense`` entries for it."""
  sizes = [min(s, DENSE_DLRM_MAX_ROWS) for s in data.MLPERF_SIZES]
  t0 = time.perf_counter()
  model = dlrm.DLRM(sizes, embedding_dim=128, param_dtype=torch.bfloat16,
                    compute_dtype=torch.bfloat16, dp_input=False,
                    dist_strategy='memory_balanced', device='cuda').init(seed)
  torch.cuda.synchronize()
  log(f'[dense-dlrm] {len(sizes)} tables, {sum(sizes):,} rows x 128 (the '
      f'MLPerf vocabularies capped at {DENSE_DLRM_MAX_ROWS:,}), bf16: '
      f'{model.total_table_gib():.3f} GiB, drawn in '
      f'{time.perf_counter() - t0:.2f} s')
  batches = dlrm_batches(model, seed + 4, TRAIN_STEPS + 3)
  (table, routed, _), = captured_lookups(model, batches[0][1][0],
                                         batches[0][0])
  lk = check_kernel_shape(table, routed.reshape(-1, 1),
                          f'dense_dlrm_w128_h1_ncap{routed.shape[0]}_bf16')
  del table, routed
  step, state = dlrm_main.make_trainer(model, 'dense', 24.0)
  batches = [(numerical, cats, labels)
             for cats, (numerical, labels) in batches]
  launches, rows, peak, times = phase_dense(
      'dense-dlrm', step, state, batches,
      {'lookup_combine': 1, 'segwalk_apply': 1})
  k = dense_entry(launches['lookup_combine'], [lk],
                  ('M', 'h', 'w', 'dtype', 'distinct_rows'),
                  {'table_rows': sum(sizes), 'step_ms': times,
                   'peak_gib': peak / 2**30})
  seg = dense_entry(launches['segwalk_apply'], rows, DENSE_GRAD_KEYS)
  return k, seg


def run_tiny(args):
  """Phases 3-9 on the synthetic tiny model; returns the two kernels'
  summaries.  Everything the model holds on the card is freed on
  return."""
  config = SYNTHETIC_MODELS[MODEL]
  t0 = time.perf_counter()
  model = SyntheticModel(config, dp_input=True, device='cuda').init(
      args.seed)
  torch.cuda.synchronize()
  log(f'[model] {config.name}: {len(model.dist_embedding.table_configs)} '
      f'tables, {model.dist_embedding.num_inputs} inputs, '
      f'{model.total_table_gib():.3f} GiB f32, drawn on the card in '
      f'{time.perf_counter() - t0:.2f} s')
  rng = np.random.default_rng(args.seed)
  (numerical, cats), _ = InputGenerator(config, BATCH, alpha=1.05,
                                        num_batches=1, seed=args.seed)[0]
  cats = pad_multi_hot(cats, model.hotness, rng)

  rows, bf16_row = phase_kernels(model, numerical, cats)
  weights, forward_launches = phase_forward(model, numerical, cats)
  phase_profile(model, numerical, cats, args.trace)
  serve_launches = phase_serving(model, weights, cats, rng)
  del weights
  step, state, calls, profile_batch, train_launches = phase_train(
      model, config, args.seed)
  seg_rows, seg_bf16 = phase_segwalk(calls)
  del calls
  torch.cuda.empty_cache()
  phase_train_profile(step, state, profile_batch)

  k = dict(KERNELS[0])
  k.update({
      'launches': train_launches['lookup_combine'],
      'launches_forward': forward_launches['lookup_combine'],
      'launches_serving': serve_launches['lookup_combine'],
      'launches_train': train_launches['lookup_combine'],
      'max_abs_err': max(r['max_abs_err'] for r in rows + [bf16_row]),
      'ms': sum(r['kernel_ms'] for r in rows),
      'plain_ms': sum(r['plain_ms'] for r in rows),
      'bound_ms': sum(r['bound_ms'] for r in rows),
      'bound_by': ('bytes' if all(r['bound_by'] == 'bytes' for r in rows)
                   else 'operations'),
      'library_ms': sum(r['library_ms'] for r in rows),
  })
  # the training path's op, summed over the groups of one step
  path = [r for r in seg_rows if r['op'] == 'adagrad_dedup']
  sgd = [r for r in seg_rows if r['op'] == 'sgd']
  seg = dict(KERNELS[1])
  seg.update({
      'launches': train_launches['segwalk_apply'],
      'launches_forward': forward_launches['segwalk_apply'],
      'launches_serving': serve_launches['segwalk_apply'],
      'launches_train': train_launches['segwalk_apply'],
      'max_abs_err': max(r['max_abs_err'] for r in seg_rows + [seg_bf16]),
      'ms': sum(r['kernel_ms'] for r in path),
      'plain_ms': sum(r['plain_ms'] for r in path),
      'bound_ms': sum(r['bound_ms'] for r in path),
      'bound_by': ('bytes' if all(r['bound_by'] == 'bytes' for r in path)
                   else 'operations'),
      'library_ms': None,
      'sgd_ms': sum(r['kernel_ms'] for r in sgd),
      'sgd_library_ms': sum(r['library_ms'] for r in sgd),
      'longest_segment': {r['stream']: r['longest_segment'] for r in path},
      'chunk': segwalk.CHUNK,
      'chunks': {r['stream']: r['chunks'] for r in path},
  })
  return k, seg


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--trace', default=None,
                      help='write the profiled forward as a Chrome trace')
  args = parser.parse_args(argv)
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device (torch.cuda.is_available() is '
          'False); this script runs on the GPU only', file=sys.stderr)
    return 1
  t_start = time.perf_counter()
  phase_card()
  phase_build()
  k, seg = run_tiny(args)
  gc.collect()
  torch.cuda.empty_cache()
  log(f'[dlrm] after the tiny model: device memory '
      f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, '
      f'{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved')
  run_dlrm(args.seed, k, seg)
  for tag, run in (('tiny', lambda: run_dense_tiny(args.seed, k)),
                   ('dlrm', lambda: run_dense_dlrm(args.seed))):
    gc.collect()
    torch.cuda.empty_cache()
    log(f'[dense-{tag}] before the model: device memory '
        f'{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated')
    dk, dseg = run()
    k.setdefault('dense', {})[tag] = dk
    seg.setdefault('dense', {})[tag] = dseg
  log(f'[done] all phases passed in {time.perf_counter() - t_start:.1f} s')
  log(json.dumps({'kernels': [k, seg]}))
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
