"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--trace forward_trace.json]

Phases, each of which exits non-zero on failure:

1. card:    name and power limit (nvidia-smi); TF32 off.
2. build:   compile every CUDA kernel of the serving path from csrc/.
3. model:   the synthetic model at full size, tables drawn on the card.
4. kernels: each kernel against its plain PyTorch version on the ids
            and tables one forward passes it (captured from that
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

Launches are counted per path: the forward's, and the serving
requests' (counted from 0 after the engine's warm-up).  The line before
last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits 1 and prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from distributed_embeddings_tpu_torch.models.synthetic import (
    SYNTHETIC_MODELS, InputGenerator, SyntheticModel)
from distributed_embeddings_tpu_torch.ops import lookup
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.serving.engine import ServingEngine
from distributed_embeddings_tpu_torch.utils import nativebuild

# H100 SXM data-sheet peaks (the bound's denominators)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
KERNELS = [{
    'name': 'lookup_combine',
    'route': 'cuda',
    'source': 'distributed_embeddings_tpu_torch/csrc/lookup_combine.cu',
    'replaces': 'distributed_embeddings_tpu/ops/pallas_lookup.py:131',
}]
MODEL = 'tiny'
BATCH = 65536  # global batch of the forward
REQUEST_SIZES = (1, 5, 64, 4096)
SERVE_BATCH = 4096


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
  the device; this counts only the device."""
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
    raise RuntimeError('torch.profiler recorded no device time')
  return total_us / 1e3 / iters


def phase_card():
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True)
  card = smi.stdout.strip().splitlines()[0]
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  log(card)
  log(f'[card] torch {torch.__version__} cuda {torch.version.cuda}; '
      'tf32 off for matmul and cudnn (allow_tf32 = False)')
  return card


def phase_build():
  t0 = time.perf_counter()
  for k in KERNELS:
    b = nativebuild.build(k['name'])
    log(f'[build] {b.name}: nvcc {b.seconds:.2f} s -> {b.path.name}')
    for line in b.log.splitlines():
      if 'registers' in line or 'spill' in line:
        log(f'[build]   {line.strip()}')
  log(f'[build] all kernels in {time.perf_counter() - t0:.2f} s')


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
  """The (table, routed ids, combiner) of every ``fused_lookup`` call of
  one forward, taken from the forward itself; its launches are not
  counted towards any path."""
  calls = []
  kernel = lookup.fused_lookup

  def record(table, routed, combiner, compute_dtype):
    calls.append((table, routed, combiner))
    return kernel(table, routed, combiner, compute_dtype)

  lookup.fused_lookup = record
  try:
    with torch.no_grad():
      model(numerical, cats)
  finally:
    lookup.fused_lookup = kernel
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
  times = []
  with torch.no_grad():
    for _ in range(n_forwards):
      t0 = time.perf_counter()
      logits = model(numerical, cats)
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
  launches = lookup.LAUNCHES
  if launches != n_forwards * n_subs:
    raise AssertionError(f'forward launched the kernel {launches} times, '
                         f'expected {n_forwards} x {n_subs} subgroups')
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
      f'kernel launches {launches} = {n_forwards} x {n_subs} subgroups')
  log(f'[forward] tables {model.total_table_gib():.3f} GiB; peak device '
      f'memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; '
      f'logits finite, first {n_check} equal the plain reference')
  return weights, launches


def phase_profile(model, numerical, cats, trace=None):
  """Where one forward's time goes: device time by kernel and the
  device's busy share of the forward's wall time (torch.profiler)."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with torch.no_grad(), profile(
      activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    model(numerical, cats)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  if trace:
    prof.export_chrome_trace(trace)
  kernels = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
  if not kernels:
    log('[profile] the profiler recorded no device time: not measured')
    return
  log(f'[profile] one forward: wall {wall_ms:.3f} ms (host clock, under '
      f'the profiler); device busy {busy_ms:.3f} ms = '
      f'{100 * busy_ms / wall_ms:.1f} % of it')
  for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                  reverse=True)[:10]:
    log(f'[profile]   {e.self_device_time_total / 1e3:8.3f} ms '
        f'x{e.count:<4d} {e.key[:90]}')


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
  launches = lookup.LAUNCHES
  lookups = engine.stats()['batches_served'] - warm_lookups
  if launches != lookups * n_subs:
    raise AssertionError(f'serving launched the kernel {launches} times '
                         f'for {lookups} lookups x {n_subs} subgroups')
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
      f'{launches} = {lookups} request lookups x {n_subs} subgroups, after '
      f'{warm_launches} in the warm-up of {warm_lookups} rungs')
  return launches


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

  config = SYNTHETIC_MODELS[MODEL]
  t0 = time.perf_counter()
  model = SyntheticModel(config, device='cuda').init(
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

  k = dict(KERNELS[0])
  k.update({
      'launches': serve_launches,
      'launches_forward': forward_launches,
      'launches_serving': serve_launches,
      'max_abs_err': max(r['max_abs_err'] for r in rows + [bf16_row]),
      'ms': sum(r['kernel_ms'] for r in rows),
      'plain_ms': sum(r['plain_ms'] for r in rows),
      'bound_ms': sum(r['bound_ms'] for r in rows),
      'bound_by': ('bytes' if all(r['bound_by'] == 'bytes' for r in rows)
                   else 'operations'),
      'library_ms': sum(r['library_ms'] for r in rows),
  })
  log(f'[done] all phases passed in {time.perf_counter() - t_start:.1f} s')
  log(json.dumps({'kernels': [k]}))
  log(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
