"""One run of one cell: set-up, the checked steps, the measured window,
the reference, the metrics and the result line.

Set-up builds the program from the seed (its tables and MLPs drawn on
the device by ``core/draw.py``) and the input pool (host arrays, as a
loader yields them).  A training cell then drives the program's own step
through its first three steps on the pool's first three batches (rows
that all differ) and reads back the state they touched; those steps also
build and load every kernel the window runs.  A scoring cell scores one
batch.  The window cycles the pool through the same call for
``--seconds``; with ``--trace 1`` its first half gives the mean step
time, a few profiled steps the device trace, and one more step the host
syncs.  Once the window has closed and the peak memory has been read,
the program is released and the plain reference runs the same batches
on the same device.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np

from perfbench.core import checks, registry

CHECKED_STEPS = 3


@dataclasses.dataclass
class Context:
  """What the metric readers (``perfbench/metrics/<name>.py``) read."""
  kind: str
  config: dict
  counts: object
  pool: list
  samples: int = 0
  window_s: float = 0.0
  steps: int = 0
  setup_s: float = 0.0
  memory_peak_bytes: Optional[int] = None
  trace: object = None
  profiled_batches: List[int] = dataclasses.field(default_factory=list)
  host_syncs: Optional[int] = None
  _counts: Dict[int, dict] = dataclasses.field(default_factory=dict)

  @property
  def mean_step_s(self) -> float:
    return self.window_s / self.steps

  def step_counts(self, b: int) -> dict:
    """The least work of one step on pool batch ``b`` (cached)."""
    if b not in self._counts:
      self._counts[b] = self.counts.step_counts(
          self.config, self.pool[b], self.kind == 'train')
    return self._counts[b]


def count_syncs(fn) -> int:
  """Device-to-host syncs of one call of ``fn`` under torch's sync debug
  mode."""
  import torch
  torch.cuda.synchronize()
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    torch.cuda.set_sync_debug_mode('warn')
    try:
      fn()
    finally:
      torch.cuda.set_sync_debug_mode(0)
  torch.cuda.synchronize()
  return sum('called a synchronizing' in str(w.message) for w in caught)


def _sync(device: str):
  import torch
  if device.startswith('cuda'):
    torch.cuda.synchronize()


def checked_steps(prog, fed: list, pool: list, fam, device: str) -> tuple:
  """The first three steps through the window's own call on the pool's
  first three batches, the state they touched read after the first and
  after the third: ``(readings, seconds spent reading)``."""
  from perfbench.reference import common
  if len(pool) < CHECKED_STEPS:
    raise ValueError('a training pool holds at least three batches')
  rows1 = common.touched(pool[:1], fam.input_table, device)
  rows = common.touched(pool[:CHECKED_STEPS], fam.input_table, device)
  losses, read_s = [], 0.0
  for k in range(CHECKED_STEPS):
    losses.append(float(prog.step(fed[k])))
    t = time.perf_counter()
    if k == 0:
      after1 = prog.read_state(rows1)
    elif k == CHECKED_STEPS - 1:
      after = prog.read_state(rows)
    read_s += time.perf_counter() - t
  return {'losses': losses, 'after1': after1, 'after': after}, read_s


@dataclasses.dataclass
class Setup:
  """What a run and the calibration build alike from one seed."""
  pool: list
  prog: object
  fed: list
  refmod: object
  fam: object
  kind: str
  start_step: int


def build(cell: registry.Cell, seed: int, device: str,
          program_hook: Optional[Callable] = None,
          marks: Optional[list] = None) -> Setup:
  """The input pool (host arrays, as a loader yields them), the program
  drawn from the seed (``program_hook`` may alter it) and the pool as it
  takes it.  ``marks`` gets ``(phase, host clock)`` after each part."""
  def mark(phase):
    if marks is not None:
      _sync(device)
      marks.append((phase, time.perf_counter()))
  family = cell.config['family']
  pool = registry.family_module('traffic', cell.mix['generator']).make_pool(
      cell.mix, cell.config, seed)
  mark('pool')
  kind = cell.cell['step']
  start_step = int(cell.cell.get('start_step', 0))
  prog = registry.family_module('models', family).Program(
      cell.config, device, seed, kind, start_step)
  if program_hook is not None:
    program_hook(prog)
  mark('program')
  fed = [prog.feed(b) for b in pool]
  refmod = registry.family_module('reference', family)
  return Setup(pool, prog, fed, refmod, refmod.Family(cell.config), kind,
               start_step)


def release(s: Setup, device: str):
  """Let go of the program's state on the card, before the reference
  runs there."""
  s.prog.release()
  s.prog = s.fed = None
  gc.collect()
  if device.startswith('cuda'):
    import torch
    torch.cuda.empty_cache()


def reference(s: Setup, cell: registry.Cell, seed: int, device: str,
              precision: str = 'exact', fault: Optional[str] = None):
  """The plain reference's side on the pool: a training cell's first
  three steps (``reference.common.train``), a scoring cell's predictions
  of every batch (``reference.common.score``)."""
  from perfbench.reference import common
  if s.kind == 'train':
    return common.train(s.fam, s.refmod.optimizer(cell.config), seed,
                        s.pool[:CHECKED_STEPS], s.start_step, device,
                        precision, fault)
  if fault is not None:
    raise ValueError('a scoring side has no training fault')
  return common.score(s.fam, seed, s.pool, device, precision)


def numbers(s: Setup, cell: registry.Cell, got, ref, device: str) -> dict:
  """The numbers compared of side ``got`` against the exact reference
  ``ref``: a training side is ``reference.common.train``-shaped (the
  program's checked steps are), a scoring side the envelope ``(lo, hi,
  malformed)`` of the predictions of each batch."""
  if s.kind == 'train':
    opt = s.refmod.optimizer(cell.config)
    return checks.train_numbers(got, ref, opt.kind, opt.rate(s.start_step),
                                opt.initial, device,
                                cell.cell.get('loss_steps'))
  return {'pred_gap': pred_gap(*got, ref)}


def pred_gap(lo, hi, malformed, ref) -> tuple:
  """``(gap, where)``: the widest gap of any prediction the window
  returned from the reference's (the elementwise envelope ``lo``..``hi``
  of each batch's answers); an answer of the wrong shape says the wrong
  thing."""
  gap, at = 0.0, None
  for b, r in enumerate(ref):
    if malformed[b]:
      g = float('inf')
    elif lo[b] is None:
      continue
    else:
      g = float(max(np.abs(hi[b] - r).max(), np.abs(lo[b] - r).max()))
    if not g <= gap:
      gap, at = g, f'batch {b}'
  return gap, at


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = 'cuda',
             program_hook: Optional[Callable] = None) -> dict:
  """The run's result (the line's keys, ``checks`` last)."""
  import torch
  marks = [('start', t_start), ('imports', time.perf_counter())]
  if device.startswith('cuda'):
    torch.zeros(1, device=device)
  _sync(device)
  marks.append(('card', time.perf_counter()))
  s = build(cell, seed, device, program_hook, marks)
  prog, fed, pool, kind = s.prog, s.fed, s.pool, s.kind
  n_pool = len(pool)
  failed = 0
  if kind == 'train':
    readings, check_s = checked_steps(prog, fed, pool, s.fam, device)
    first = CHECKED_STEPS
  else:
    prog.predict(fed[0])
    check_s = 0.0
    lo = [None] * n_pool
    hi = [None] * n_pool
    malformed = [False] * n_pool
    first = 0

  def one(i: int):
    nonlocal failed
    b = i % n_pool
    if kind == 'train':
      if not math.isfinite(float(prog.step(fed[b]))):
        failed += 1
    else:
      p = prog.predict(fed[b])
      if p.shape != (pool[b]['labels'].shape[0],):
        malformed[b] = True
      elif lo[b] is None:
        lo[b], hi[b] = p.copy(), p.copy()
      else:
        np.minimum(lo[b], p, out=lo[b])
        np.maximum(hi[b], p, out=hi[b])

  _sync(device)
  marks.append(('first steps', time.perf_counter()))
  batch_size = pool[0]['labels'].shape[0]
  measure_s = seconds / 2 if trace else seconds
  t0 = time.perf_counter()
  i = first
  while True:
    one(i)
    i += 1
    if time.perf_counter() - t0 >= measure_s:
      break
  t1 = time.perf_counter()
  steps = i - first
  ctx = Context(kind=kind, config=cell.config,
                counts=registry.family_module('counts',
                                              cell.config['family']),
                pool=pool,
                samples=steps * batch_size, window_s=t1 - t0, steps=steps,
                setup_s=t0 - t_start - check_s)
  if trace:
    from distributed_embeddings_tpu_torch.obs import trace as span_tracer
    from perfbench.core import devtrace
    n_prof = int(cell.cell.get('profiled_steps', 8))
    ctx.profiled_batches = [(i + k) % n_pool for k in range(n_prof)]
    own_spans = []
    prog.instrument(own_spans)
    ctx.trace = devtrace.profile_steps(lambda k: one(i + k), n_prof,
                                       span_tracer, own_spans)
    i += n_prof
    ctx.host_syncs = count_syncs(lambda: one(i))
    i += 1
  if device.startswith('cuda'):
    ctx.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
  attempted = i - first

  # the reference, once the program has let go of the card
  t_ref = time.perf_counter()
  del prog, fed
  release(s, device)
  got = readings if kind == 'train' else (lo, hi, malformed)
  numbers_ = numbers(s, cell, got, reference(s, cell, seed, device), device)
  verdict = checks.judge(numbers_, cell.cell['checks'])
  phases = ', '.join(f'{name} {t - t0_:.3f}' for (_, t0_), (name, t)
                     in zip(marks, marks[1:]))
  print(f'perfbench: set-up {ctx.setup_s:.3f} s ({phases}; checked-state '
        f'reads {check_s:.3f}); window {ctx.window_s:.3f} s, {steps} steps; '
        f'reference and checks {time.perf_counter() - t_ref:.3f} s',
        file=sys.stderr)

  metrics = {}
  for m in (cell.per_layer if trace else cell.end_to_end):
    value = registry.metric_reader(
        m['name'], cell.root / 'perfbench').read(ctx)
    if value is not None:
      metrics[m['name']] = {'value': value, 'unit': m['unit']}
  dev = {'platform': 'gpu' if device.startswith('cuda') else 'cpu',
         'kind': (torch.cuda.get_device_name(0)
                  if device.startswith('cuda') else 'cpu'),
         'count': int(cell.spec['chips']),
         'memory_peak_bytes': ctx.memory_peak_bytes}
  out = {'correct': verdict['correct'], 'attempted': attempted,
         'failed': failed, 'metrics': metrics, 'device': dev}
  if ctx.trace is not None:
    dev['busy_s'] = ctx.trace.busy_us / 1e6
    dev['window_s'] = ctx.trace.window_us / 1e6
    out['breakdown'] = ctx.trace.breakdown()
  out['checks'] = verdict['checks']
  return out
