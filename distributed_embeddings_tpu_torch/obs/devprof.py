"""Per-phase device-time attribution: the port's own copy of the
segmented-dispatch profiler, ``distributed_embeddings_tpu/obs/devprof.py``.

The tracer's step spans time host work; this module times the step's
phases as separately synced programs on the live device:

- ``dev/fwd/exchange``: the dp->mp id exchange and the row-return
  exchange alone (``overlap.build_exchange_program``, real ids, real
  bytes), measured directly;
- ``dev/fwd/lookup_combine``: the lookup-only forward (``dist.apply``)
  minus the exchange program, derived;
- ``dev/bwd/exchange``: the cotangent-shaped row exchange alone
  (``build_exchange_program(rows_only=True)``), measured directly;
- ``dev/bwd/grad``: forward and backward (``forward_with_residuals``,
  then ``backward_to_mp`` on cotangents ``out * 1e-3``) minus the
  forward and the backward exchange, derived;
- ``dev/apply/update``: ``sparse_apply_updates`` alone on the streams
  the forward and backward produced, measured directly;
- ``dev/serve/execute``: the serving engine's lookup at each rung
  (``profile_serving``), measured directly.

This is segmented dispatch, not a hardware profile: derived phases are
differences of synced walls, floored at 0, and ``coverage_pct``
(``sum(phases) / step_ms``) shows how far the segments add up to the
whole step.  A ``dcn_sharding`` layer adds the ici / dcn lanes of the
exchange phases (``DCN_LANES``): the intra-slice twin program measured
(``dcn_leg=False``), the DCN leg the remainder, nested inside the parent
phase.  The apply and the whole step run on a private clone of the
params and optimizer state, never on the caller's.

Two clocks.  ``phases`` and ``step_ms`` use JAX's: the least of ``reps``
synced host walls of each program after one warm-up call.  In eager
PyTorch that wall is mostly the host queueing launches, so beside each
program ``StepProfile.device`` records its device time (the port's one
difference from JAX's ``StepProfile``): CUDA events around ``reps``
calls queued while the device spins (``torch.cuda._sleep``), clock
``'queued'``.  A program that waits on the device inside (a host sync)
cannot be queued ahead; its time is then the events' with the host's
gaps, clock ``'events'``, never a busy time.  On the CPU both clocks are
the synced wall, clock ``'wall'``.  ``device_phases`` applies the phase
arithmetic to the device times.

PyTorch has no XLA cost analysis: every program's ``cost`` is None and
``_cost_cross_check`` says so, JAX's path for such a backend.

Results emit as ``ph='X'`` events on the 'device' track
(``obs.trace.device_tid``) and into the ``devprof.*`` metrics while obs
is armed, and journal one ``devprof_profile`` event either way.
"""

from __future__ import annotations

import dataclasses
import time

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.utils import resilience

# the training step's device lane, in order (serving adds
# dev/serve/execute per rung)
STEP_PHASES = ('dev/fwd/exchange', 'dev/fwd/lookup_combine',
               'dev/bwd/exchange', 'dev/bwd/grad', 'dev/apply/update')

# the ici / dcn lanes of the two exchange phases of a dcn_sharding layer:
# nested inside their parent phase, never added to coverage
DCN_LANES = ('dev/fwd/exchange/ici', 'dev/fwd/exchange/dcn',
             'dev/bwd/exchange/ici', 'dev/bwd/exchange/dcn')

# nested-prefix slack on the cost model's bytes: fwd <= fwd+bwd <= step
_COST_TOL = 1.10

# the device spins this many times the host's time to queue the calls
# (their synced wall) while it queues them
_SPIN_MARGIN = 4.0
_SPIN_MIN_MS = 20.0
_SPIN_CYCLES_PER_MS = 2_000_000  # torch.cuda._sleep spins clock cycles;
                                 # an H100 runs at most 1.98 GHz


@dataclasses.dataclass
class StepProfile:
  """One segmented-dispatch profile of the training step.

  ``phases`` maps ``STEP_PHASES`` to ms on the synced-wall clock
  (``direct``: measured as its own program; else a difference of walls,
  floored at 0); ``step_ms`` the whole embedding step (forward, backward
  and apply) as one program; ``coverage_pct`` ``sum(phases) /
  step_ms``; ``cost`` the per-program cost model (None here: no backend
  cost analysis) and ``cost_ok`` / ``cost_note`` its cross-check.
  ``dcn_lanes`` / ``dcn_direct``: a ``dcn_sharding`` layer's lanes,
  else None.  ``device`` (the port's field): each program's device time
  and its clock, ``{program: {'ms': ms, 'clock': 'queued' | 'events' |
  'wall'}}`` (module docstring)."""
  phases: Dict[str, float]
  direct: Dict[str, bool]
  step_ms: float
  coverage_pct: float
  cost: Dict[str, Optional[Dict[str, float]]]
  cost_ok: Optional[bool]
  cost_note: str = ''
  reps: int = 0
  dcn_lanes: Optional[Dict[str, float]] = None
  dcn_direct: Optional[Dict[str, bool]] = None
  device: Dict[str, Dict[str, Any]] = dataclasses.field(
      default_factory=dict)


def _sync(device: torch.device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def _timed_ms(fn: Callable[[], Any], reps: int, device: torch.device
              ) -> float:
  """The least synced host wall (ms) of ``reps`` calls of ``fn`` after
  one warm-up call."""
  fn()
  _sync(device)
  best = float('inf')
  for _ in range(max(1, int(reps))):
    t0 = time.perf_counter()
    fn()
    _sync(device)
    best = min(best, (time.perf_counter() - t0) * 1000.0)
  return best


def device_clock_ms(fn: Callable[[], Any], reps: int,
                    device: torch.device, wall_ms: float
                    ) -> Tuple[float, str]:
  """``(ms, clock)``: the device time of one call of ``fn``, the mean
  over ``reps`` back-to-back calls between two CUDA events while the
  device first spins for ``_SPIN_MARGIN`` times the calls' synced wall
  (``wall_ms`` each).  Clock ``'queued'`` when the device had not
  reached the first event by the time the host had queued the last
  call; else ``'events'`` (the calls wait on the device, and the time
  keeps the host's gaps).  On the CPU: ``(wall_ms, 'wall')``."""
  if device.type != 'cuda':
    return wall_ms, 'wall'
  n = max(1, int(reps))
  _sync(device)
  spin_ms = max(_SPIN_MIN_MS, _SPIN_MARGIN * wall_ms * n)
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda._sleep(int(spin_ms * _SPIN_CYCLES_PER_MS))
  start.record()
  for _ in range(n):
    fn()
  end.record()
  ahead = not start.query()
  end.synchronize()
  return start.elapsed_time(end) / n, ('queued' if ahead else 'events')


def _phases(ms: Dict[str, float]) -> Dict[str, float]:
  """The phase arithmetic over the programs' times."""
  return {
      'dev/fwd/exchange': ms['exf'],
      'dev/fwd/lookup_combine': max(0.0, ms['fwd'] - ms['exf']),
      'dev/bwd/exchange': ms['exb'],
      'dev/bwd/grad': max(0.0, ms['fwdbwd'] - ms['fwd'] - ms['exb']),
      'dev/apply/update': ms['apply'],
  }


def device_phases(prof: StepProfile) -> Dict[str, float]:
  """``prof``'s phases on the device clock (each program's
  ``prof.device`` time through the same arithmetic; read each clock
  from ``prof.device``)."""
  return {k: round(v, 4) for k, v in _phases(
      {name: d['ms'] for name, d in prof.device.items()}).items()}


def _cost_cross_check(cost: Dict[str, Optional[Dict[str, float]]]):
  """The nested-prefix contract: forward within forward+backward within
  step, so their cost-model bytes must be monotone (within
  ``_COST_TOL``).  ``(ok, note)``; ``(None, note)`` where a program of
  the chain has no cost."""
  chain = [cost.get('fwd'), cost.get('fwdbwd'), cost.get('step')]
  if any(c is None or not c.get('bytes') for c in chain):
    return None, 'cost model unavailable on this backend'
  nbytes = [c['bytes'] for c in chain]
  for a, b, what in ((nbytes[0], nbytes[1], 'fwd <= fwd+bwd'),
                     (nbytes[1], nbytes[2], 'fwd+bwd <= step')):
    if a > b * _COST_TOL:
      return False, (f'nested-prefix byte monotonicity broken: {what} '
                     f'({a:.3g} > {b:.3g} bytes accessed) — the '
                     'segmented programs no longer nest (design §19)')
  return True, ''


def _refuse(dist):
  if not getattr(dist, 'dp_input', False):
    raise ValueError('devprof.profile_step needs a dp_input layer (the '
                     'segmented phases are the dp<->mp step phases)')
  if getattr(dist, 'hot_enabled', False):
    raise ValueError(
        'devprof.profile_step does not support hot-cache layers: the '
        'cached forward splits every phase into hot/cold legs the '
        'segmentation would misattribute; profile the plain layer')
  if getattr(dist, 'cold_tier', None) is not None:
    raise ValueError(
        'devprof.profile_step does not support cold-tier layers (the '
        'host fetch leg is not a device phase; ColdFetchPipeline '
        'measures it); profile the untiered twin')


def _clone(tree):
  """A private copy of a tree of tensors (dicts, lists, tuples)."""
  if isinstance(tree, torch.Tensor):
    return tree.clone()
  if isinstance(tree, dict):
    return {k: _clone(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(_clone(v) for v in tree)
  return tree


def profile_step(dist, cats, params=None, emb_optimizer=None,
                 reps: int = 3) -> StepProfile:
  """Segmented-dispatch profile of the embedding train step on the live
  device; the module docstring lists the phases.

  Args:
    dist: a plain ``dp_input`` ``DistributedEmbedding`` (hot-cache and
      cold-tier layers refuse, before any work).
    cats: one representative batch of this rank's embedding inputs.
    params: embedding params (``dist.init(0)`` when omitted); read only.
    emb_optimizer: the sparse optimizer whose apply to profile (default
      ``SparseSGD(0.01)``: no accumulator to copy).
    reps: timed synced calls a program (the least wins), and the calls
      between the device clock's events.

  Emits the device lane and the metrics while obs is armed and journals
  one ``devprof_profile`` event either way.
  """
  from distributed_embeddings_tpu_torch.parallel import overlap as overlap_lib
  from distributed_embeddings_tpu_torch.parallel import sparse as sparse_lib

  _refuse(dist)
  device = dist.device
  with torch.no_grad():
    if params is None:
      params = dist.init(0)
    opt = (emb_optimizer if emb_optimizer is not None
           else sparse_lib.SparseSGD(learning_rate=0.01))
    inputs, _, _ = dist._prepare_inputs(cats)
    programs: Dict[str, Callable[[], Any]] = {}

    # the exchange-only programs (direct); a dcn_sharding layer's
    # intra-slice twins beside them
    exf_fn, exf_in = overlap_lib.build_exchange_program(dist, cats)
    programs['exf'] = lambda: exf_fn(*exf_in)
    exb_fn, exb_in = overlap_lib.build_exchange_program(dist, cats,
                                                        rows_only=True)
    programs['exb'] = lambda: exb_fn(*exb_in)
    hier = (bool(getattr(dist, 'dcn_sharding', False))
            and dist.num_slices > 1)
    if hier:
      exfi_fn, exfi_in = overlap_lib.build_exchange_program(
          dist, cats, dcn_leg=False)
      programs['exf_ici'] = lambda: exfi_fn(*exfi_in)
      exbi_fn, exbi_in = overlap_lib.build_exchange_program(
          dist, cats, rows_only=True, dcn_leg=False)
      programs['exb_ici'] = lambda: exbi_fn(*exbi_in)

    # the lookup-only forward
    programs['fwd'] = lambda: dist.apply(params, inputs)

    def fwd_bwd(p):
      # cotangents from the outputs, so the forward's work is all used
      outs, residuals, (gb, hotness) = dist.forward_with_residuals(
          p, inputs)
      d_emb = [o * torch.tensor(1e-3, dtype=o.dtype, device=o.device)
               for o in outs]
      gsubs = dist.backward_to_mp(d_emb, gb, hotness)
      return residuals, gsubs, gb, hotness

    programs['fwdbwd'] = lambda: fwd_bwd(params)
    # the streams the isolated apply steps with
    res, gsubs, gb, hotness = fwd_bwd(params)

    # the state-updating programs step a private clone in place
    own_p = _clone(params)
    own_s = opt.init(dist, own_p)

    def apply_fn():
      sparse_lib.sparse_apply_updates(dist, opt, own_p, own_s, res, gsubs,
                                      opt.learning_rate, gb, hotness)

    def step_fn():
      r, g, b, h = fwd_bwd(own_p)
      sparse_lib.sparse_apply_updates(dist, opt, own_p, own_s, r, g,
                                      opt.learning_rate, b, h)

    programs['apply'] = apply_fn
    programs['step'] = step_fn

    walls: Dict[str, float] = {}
    dev: Dict[str, Dict[str, Any]] = {}
    for name, fn in programs.items():
      walls[name] = _timed_ms(fn, reps, device)
      ms, clock = device_clock_ms(fn, reps, device, walls[name])
      dev[name] = {'ms': round(ms, 4), 'clock': clock}
    del own_p, own_s, res, gsubs
  cost: Dict[str, Optional[Dict[str, float]]] = {n: None for n in programs}

  phases = _phases(walls)
  direct = {'dev/fwd/exchange': True, 'dev/fwd/lookup_combine': False,
            'dev/bwd/exchange': True, 'dev/bwd/grad': False,
            'dev/apply/update': True}
  dcn_lanes = None
  dcn_direct = None
  if hier:
    dcn_lanes = {
        'dev/fwd/exchange/ici': round(walls['exf_ici'], 4),
        'dev/fwd/exchange/dcn': round(
            max(0.0, walls['exf'] - walls['exf_ici']), 4),
        'dev/bwd/exchange/ici': round(walls['exb_ici'], 4),
        'dev/bwd/exchange/dcn': round(
            max(0.0, walls['exb'] - walls['exb_ici']), 4),
    }
    dcn_direct = {'dev/fwd/exchange/ici': True,
                  'dev/fwd/exchange/dcn': False,
                  'dev/bwd/exchange/ici': True,
                  'dev/bwd/exchange/dcn': False}
  step_ms = walls['step']
  coverage = (100.0 * sum(phases.values()) / step_ms if step_ms > 0
              else 0.0)
  cost_ok, cost_note = _cost_cross_check(cost)
  prof = StepProfile(phases={k: round(v, 4) for k, v in phases.items()},
                     direct=direct, step_ms=round(step_ms, 4),
                     coverage_pct=round(coverage, 2), cost=cost,
                     cost_ok=cost_ok, cost_note=cost_note,
                     reps=int(reps), dcn_lanes=dcn_lanes,
                     dcn_direct=dcn_direct, device=dev)

  # emit: the device lane, the metrics, the journal
  if obs_trace.enabled():
    tid = obs_trace.device_tid()
    t = obs_trace.now() - sum(phases.values()) / 1000.0
    starts = {}
    for name in STEP_PHASES:
      starts[name] = t
      obs_trace.complete(name, t, phases[name] / 1000.0, tid=tid,
                         direct=direct[name])
      t += phases[name] / 1000.0
    if dcn_lanes is not None:
      # each pair nests inside its parent exchange span, ici first; an
      # ici twin timed longer than its parent (noise: its dcn lane is
      # then 0) is drawn clipped to the parent, its value kept as timed
      for parent in ('dev/fwd/exchange', 'dev/bwd/exchange'):
        t_lane = starts[parent]
        for lane in (f'{parent}/ici', f'{parent}/dcn'):
          dur = min(dcn_lanes[lane], phases[parent]) / 1000.0
          obs_trace.complete(lane, t_lane, dur, tid=tid,
                             direct=dcn_direct[lane])
          t_lane += dur
  obs_metrics.inc('devprof.runs')
  for ms in prof.phases.values():
    obs_metrics.observe('devprof.phase_ms', ms)
  if prof.dcn_lanes:
    for ms in prof.dcn_lanes.values():
      obs_metrics.observe('devprof.phase_ms', ms)
  resilience.journal('devprof_profile', phases=prof.phases,
                     step_ms=prof.step_ms,
                     coverage_pct=prof.coverage_pct,
                     cost=prof.cost, cost_ok=prof.cost_ok,
                     cost_note=prof.cost_note, reps=prof.reps,
                     device=prof.device,
                     **({'dcn_lanes': prof.dcn_lanes}
                        if prof.dcn_lanes else {}))
  return prof


def profile_serving(engine, reps: int = 3, seed: int = 0
                    ) -> Dict[int, float]:
  """The serving execute phase at each rung: the least synced wall of
  ``reps`` ``engine.dist.apply`` calls on uniform-random ids of the
  rung's shape (after the engine's warm-up and one more call), the host's
  dispatch included, as a live request pays it; emitted as
  ``dev/serve/execute`` events with the rung in ``args``.  Returns
  ``{rung: ms}`` and journals one ``devprof_profile`` event."""
  import numpy as np

  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib

  engine.warmup()
  dist = engine.dist
  rng = np.random.default_rng(seed)
  out: Dict[int, float] = {}
  with torch.no_grad():
    for bucket in engine.buckets:
      cats = []
      for i, tid_ in enumerate(dist.plan.input_table_map):
        vocab = dist.table_configs[tid_].input_dim
        h = engine.hotness[i]
        shape = (bucket,) if h == 1 else (bucket, h)
        cats.append(rng.integers(0, vocab, size=shape).astype(np.int32))
      if dist.mesh.product_size > 1:
        # each rank passes its block of the rung, as engine.lookup does
        block = mesh_lib.batch_sharding(dist.mesh, bucket)
        cats = [c[block] for c in cats]
      dist.apply(engine.params, cats)
      _sync(dist.device)
      best = float('inf')
      t_begin = obs_trace.now()
      for _ in range(max(1, int(reps))):
        t0 = time.perf_counter()
        dist.apply(engine.params, cats)
        _sync(dist.device)
        best = min(best, (time.perf_counter() - t0) * 1000.0)
      out[int(bucket)] = round(best, 4)
      obs_trace.complete('dev/serve/execute', t_begin, best / 1000.0,
                         tid=obs_trace.device_tid(), rung=int(bucket))
      obs_metrics.observe('devprof.phase_ms', best)
  obs_metrics.inc('devprof.runs')
  resilience.journal('devprof_profile',
                     serve_rung_ms={str(k): v for k, v in out.items()})
  return out
