"""Hybrid data+model-parallel training glue: the port's counterpart of
``distributed_embeddings_tpu/parallel/grad.py``.

The reference's Horovod patches do two jobs (`dist_model_parallel.py:
678-736`): ``broadcast_variables`` makes the data-parallel variables of
every process equal to the root's, and ``DistributedGradientTape``
averages the data-parallel gradients over the processes.  The JAX
package gets both from one SPMD program; the port runs one process per
device, so it does both with ``torch.distributed``
(``broadcast_variables``, ``allreduce_mean_``).  Model-parallel state
(the ``'embedding'`` tables) is never synchronised: each rank owns its
shard.

``make_train_step`` is the dense autodiff trainer, the JAX package's
idiomatic entry point: autograd through the whole model, tables
included (``DistributedEmbedding.apply`` is differentiable), then one
optimizer update of every param.  ``DistributedGradientTape`` takes the
same gradients for a loop of the caller's own.  ``fit`` drives either
step: log windows with one host sync each, eval, callbacks, resume from
a checkpoint, a step watchdog and the self-healing anomaly policy
(terminate, or roll back to the newest valid checkpoint in place).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.analysis import commsan
from distributed_embeddings_tpu_torch.obs import metrics as obs_metrics
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.parallel.coldtier import (
    TierIntegrityError)
from distributed_embeddings_tpu_torch.utils import resilience

ANOMALY_POLICIES = (None, 'terminate', 'rollback', 'rollback_skip')


class _Anomaly(Exception):
  """Internal control flow of ``fit``'s anomaly policy: a detected
  anomaly unwinds to the policy handler, which terminates or rolls
  back in place."""

  def __init__(self, kind: str, step: int, detail: str = ''):
    self.kind = kind
    self.step = int(step)
    self.detail = detail
    super().__init__(f'{kind} at step {step}: {detail}')


class TrainState(NamedTuple):
  params: Any
  opt_state: Any
  step: int


def _world(group: Optional[torch_dist.ProcessGroup]) -> int:
  if group is None or not torch_dist.is_initialized():
    return 1
  return torch_dist.get_world_size(group)


def broadcast_variables(params, root_rank: int = 0,
                        group: Optional[torch_dist.ProcessGroup] = None):
  """Make every rank's data-parallel params equal to ``root_rank``'s, in
  place (``dmp.broadcast_variables``).  ``params`` is a dict of tensors;
  its ``'embedding'`` entry (model-parallel shards) is skipped.  A world
  of one returns at once.  Returns ``params``."""
  if _world(group) == 1:
    return params
  src = torch_dist.get_global_rank(group, root_rank)
  with torch.no_grad():
    for name, t in params.items():
      if name != 'embedding':
        torch_dist.broadcast(t, src=src, group=group)
  return params


def allreduce_mean_(tensors: Sequence[torch.Tensor],
                    group: Optional[torch_dist.ProcessGroup] = None) -> None:
  """Average each tensor over the ranks of ``group``, in place: the job
  ``DistributedGradientTape`` does for data-parallel gradients.  A world
  of one leaves them as they are."""
  world = _world(group)
  if world == 1:
    return
  for t in tensors:
    torch_dist.all_reduce(t, group=group)
    t.div_(world)


def _default_group(group: Optional[torch_dist.ProcessGroup]):
  """``group``, or the default world when ``torch.distributed`` runs more
  than one process (as ``mesh.create_mesh`` takes it)."""
  if (group is None and torch_dist.is_available()
      and torch_dist.is_initialized() and torch_dist.get_world_size() > 1):
    return torch_dist.group.WORLD
  return group


class DistributedGradientTape:
  """Gradients of a local-mean loss as the gradients of the global mean
  (the reference's ``DistributedGradientTape``,
  ``dist_model_parallel.py:695-736``).

  ``loss_fn(params, *args)`` returns the mean loss over this rank's
  LOCAL batch; ``params`` is ``{'embedding': this rank's group tables,
  **dense}`` (nested dicts of tensors).  ``gradient`` differentiates it
  with autograd and then does what the reference's tape does: dense
  gradients are averaged over the ranks; each table gradient, which the
  exchange's backward already summed over every rank's cotangents, is
  scaled by ``1 / world_size``.  A world of one calls no collective.

  A quantized layer's tables (``table_dtype``) are refused: dense
  autodiff cannot differentiate through integer payloads.

  On a two-axis mesh (``dist`` given), the batch splits over both axes:
  the dense gradients average over every rank, and a layer whose tables
  replicate across slices (no ``dcn_sharding``) sums each table
  gradient over the ``dcn`` group first, in rank order
  (``_OrderedSum``): the sum JAX's autodiff derives from the
  replication.  A ``dcn_sharding`` layer's table gradients already
  carry every slice's cotangents (its DCN exchange is differentiable),
  and so does a hot layer's replicated ``hot_group_*`` buffers' (the hot
  backward sums them over every rank of the mesh).

  Args:
    loss_fn: the local-mean loss.
    group: the process group the batch splits over; default: the
      world, or a world of one without ``torch.distributed``.
    dist: the model's ``DistributedEmbedding``; when given, the group is
      its mesh's product and the cross-slice sum above applies.
  """

  def __init__(self, loss_fn: Callable,
               group: Optional[torch_dist.ProcessGroup] = None,
               dist=None):
    self._loss_fn = loss_fn
    self.dcn_group, self.num_slices = None, 1
    if dist is not None:
      group = dist.mesh.product_group if group is None else group
      if dist.num_slices > 1 and not dist.dcn_sharding:
        self.dcn_group, self.num_slices = dist.mesh.dcn_group, dist.num_slices
    self.group = _default_group(group)

  def value_and_gradient(self, params, *args, **kwargs):
    """``(global-mean loss, grads)``: grads a tree of ``params``'
    structure, the loss a detached 0-d tensor."""
    world = _world(self.group)
    if any(not (p.is_floating_point() and p.element_size() > 1)
           for p in optim.tree_leaves(params.get('embedding', {}))):
      # a quantized layer's int8 / float8 payloads
      from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
          QUANTIZED_AUTODIFF)
      raise ValueError(QUANTIZED_AUTODIFF)
    # fresh leaves on the params' storage: the caller's tensors never
    # enter a graph
    leaves = optim.tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
    loss = self._loss_fn(leaves, *args, **kwargs)
    flat = iter(torch.autograd.grad(loss, optim.tree_leaves(leaves),
                                    allow_unused=True))

    def take(p):
      # a param the loss does not reach gets a zero gradient, as under
      # jax.grad
      g = next(flat)
      return torch.zeros_like(p) if g is None else g

    grads = optim.tree_map(take, leaves)
    loss = loss.detach()
    dense = {k: g for k, g in grads.items() if k != 'embedding'}
    allreduce_mean_(optim.tree_leaves(dense) + [loss], self.group)
    if self.dcn_group is not None:
      # function-level import, as for QUANTIZED_AUTODIFF above
      from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
          _OrderedSum)
      for k, g in grads.get('embedding', {}).items():
        # a hot buffer's gradient came summed over every rank of the
        # mesh (the hot backward's own sum, ``_HotApply``)
        if not k.startswith('hot_'):
          _OrderedSum(g, self.dcn_group, self.num_slices).wait()
    if world > 1:
      for g in optim.tree_leaves(grads.get('embedding', {})):
        g.div_(world)
    return loss, grads

  def gradient(self, params, *args, **kwargs):
    return self.value_and_gradient(params, *args, **kwargs)[1]


def make_train_step(loss_fn: Callable, optimizer,
                    group: Optional[torch_dist.ProcessGroup] = None,
                    dist=None) -> Callable:
  """Build the dense autodiff train step (JAX ``make_train_step``).

  Args:
    loss_fn: ``loss_fn(params, batch) -> scalar``, the mean loss over
      this rank's LOCAL batch; ``params`` is ``{'embedding': this rank's
      group tables, **dense params}``.  The step turns it into the JAX
      package's global mean (``DistributedGradientTape``).
    optimizer: a port ``GradientTransformation`` (``optim.sgd``,
      ``optim.adagrad``), applied to every param, tables included.
    group / dist: as in ``DistributedGradientTape`` (pass ``dist`` on a
      two-axis mesh).

  Returns:
    ``step(state: TrainState, batch) -> (TrainState, loss)``, ``loss``
    the global mean (a 0-d tensor).  The params are updated IN PLACE
    (under ``torch.no_grad()``), as the JAX step's donated buffers are
    reused: the returned state holds the same tensors.
  """
  tape = DistributedGradientTape(loss_fn, group, dist)

  def step(state: TrainState, batch):
    with obs_trace.span('train/step', step=state.step + 1):
      loss, grads = tape.value_and_gradient(state.params, batch)
      with obs_trace.span('dense/update'):
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        with torch.no_grad():
          params = optim.tree_map(lambda p, u: p.add_(u.to(p.dtype)),
                                  state.params, updates)
    return TrainState(params, opt_state, state.step + 1), loss

  return step


def init_train_state(params, optimizer) -> TrainState:
  """Initial ``TrainState`` for ``make_train_step``: ``params`` is
  ``{'embedding': this rank's group tables, **dense params}``."""
  return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def fit(step_fn: Callable,
        state: TrainState,
        data,
        steps: Optional[int] = None,
        *,
        log_every: int = 100,
        eval_fn: Optional[Callable] = None,
        eval_every: Optional[int] = None,
        callbacks=(),
        verbose: bool = True,
        print_fn: Callable = print,
        resume_from: Optional[str] = None,
        dist=None,
        terminate_on_nan: bool = False,
        step_timeout_s: Optional[float] = None,
        on_anomaly: Optional[str] = None,
        rollback_dir: Optional[str] = None,
        rollback_budget: int = 3,
        data_factory: Optional[Callable] = None,
        auditor=None,
        spike_zscore: Optional[float] = None,
        spike_warmup: int = 10):
  """Keras-``fit``-like loop over the train steps of the port (JAX
  ``grad.fit``): iterate, keep the losses on the device between log
  points (one host sync per ``log_every`` steps, none per step), run
  periodic eval and callbacks; the state is a value the caller owns.

  Args:
    step_fn: ``make_train_step`` / ``make_hybrid_train_step``'s step,
      called as ``step_fn(state, *batch_args)``.
    state: the initial ``TrainState``.
    data: iterable of per-step argument tuples (everything after
      ``state``): ``(batch,)`` for ``make_train_step``, ``(cats,
      batch)`` for the hybrid step.
    steps: stop at this step (``None`` drains ``data``).  After a resume
      it still counts from step 0: the TOTAL budget.
    log_every: steps between loss syncs, history entries and callbacks.
    eval_fn: ``eval_fn(state) -> dict`` of Python metrics.
    eval_every: steps between evals (default ``log_every``).
    callbacks: ``cb(step, state, logs)`` at every log or eval point
      (``StopIteration`` stops the run).
    verbose / print_fn: one line per log point.
    resume_from: a checkpoint ``.npz`` or a directory (newest valid file
      wins, ``checkpoint.load_latest_valid``); restored into ``state``
      in place (``checkpoint.restore_train_state``), and the step
      resumes, so ``data`` must start at the first untrained batch.
      Needs ``dist``.
    dist: the model's ``DistributedEmbedding``.
    terminate_on_nan: the old spelling of ``on_anomaly='terminate'``.
    on_anomaly: the self-healing policy.  An anomaly is a non-finite
      loss in a log window, a loss spike past the EMA z-score gate
      (``spike_zscore``) or a failed state audit (``auditor``).  Each
      journals ``anomaly_detected`` and lands in
      ``history['anomalies']``.  ``None``: no detection.
      ``'terminate'``: stop with a journaled reason.  ``'rollback'``:
      restore the newest VALID checkpoint under ``rollback_dir`` in
      place (corrupt candidates quarantined), reposition the input with
      ``data_factory`` and replay the window (bit-exact for a transient
      corruption).  ``'rollback_skip'``: the same, but the input skips
      the offending window (journaled ``skip_window``).  At most
      ``rollback_budget`` rollbacks; the next anomaly journals
      ``rollback_budget_exhausted`` and terminates.  A cold-tier step's
      ``coldtier.TierIntegrityError`` (a corrupted host-tier row, caught
      at fetch time and journaled ``tier_integrity_failure``) is the
      anomaly ``'tier_integrity'`` under a policy, and raises without
      one.
    rollback_dir: the checkpoint directory the rollback policies scan.
    rollback_budget: in-place rollbacks per call.
    data_factory: ``step -> iterable`` positioned at the batch that
      trains ``step + 1``; needed by the rollback policies.
    auditor: a ``parallel.audit.StateAuditor``, called every
      ``auditor.every`` steps before that step's log point (a failing
      state never reaches the checkpoint callback).
    spike_zscore / spike_warmup: arm ``audit.LossSpikeGate``.
    step_timeout_s: hung-step watchdog: every step and every log-point
      sync runs under this timeout (``resilience.call_with_timeout``, on
      the caller's CUDA device and stream); on expiry tracebacks are
      dumped, ``watchdog_fired`` journaled and ``StepHangError`` raised.
      ``None`` (default) adds nothing.

  Spans (``obs/trace.py``): ``fit`` records ``train/sync`` for each log
  window's sync and no ``train/step`` of its own: the port's step
  functions (``make_train_step``, ``make_hybrid_train_step``) record one
  a step, their phases inside it, so a step function of the caller's
  own records none.

  Returns:
    ``(state, history)``: ``history['step']`` / ``['loss']`` one entry a
    log point, eval metrics in their own lists aligned with
    ``history['eval_step']`` (a metric named ``step``, ``loss`` or
    ``eval_step`` becomes ``eval_<name>``).
  """
  eval_every = eval_every or log_every
  if on_anomaly not in ANOMALY_POLICIES:
    raise ValueError(f'on_anomaly must be one of {ANOMALY_POLICIES}, '
                     f'got {on_anomaly!r}')
  if on_anomaly is None and (terminate_on_nan or auditor is not None
                             or spike_zscore is not None):
    on_anomaly = 'terminate'
  if on_anomaly in ('rollback', 'rollback_skip'):
    if dist is None or rollback_dir is None:
      raise ValueError(
          f'fit(on_anomaly={on_anomaly!r}) needs rollback_dir= (the '
          'checkpoint directory to restore from, normally where a '
          'CheckpointCallback in callbacks= writes) and dist= (the '
          'DistributedEmbedding defining the resharding layout)')
    if data_factory is None:
      raise ValueError(
          f'fit(on_anomaly={on_anomaly!r}) needs data_factory=, a '
          'callable step -> iterable positioned at the batch that trains '
          'step+1 (deterministic sources: lambda s: iter(batches[s:])); '
          'a bare iterator cannot be rewound after a rollback')
  gate = None
  if spike_zscore is not None:
    from distributed_embeddings_tpu_torch.parallel.audit import (
        LossSpikeGate)
    gate = LossSpikeGate(zscore=spike_zscore, warmup=spike_warmup)
  reserved = ('step', 'loss', 'eval_step')
  history: dict = {'step': [], 'loss': [], 'eval_step': []}
  window = []  # the losses since the last sync, on the device
  i = 0
  it = iter(data) if data is not None else None
  if resume_from is not None:
    if dist is None:
      raise ValueError('fit(resume_from=...) needs dist= (the '
                       'DistributedEmbedding defining the resharding '
                       'layout)')
    from distributed_embeddings_tpu_torch.parallel.checkpoint import (
        restore_train_state)
    state, ckpt_path = restore_train_state(dist, state, resume_from)
    i = int(state.step)
    if verbose:
      print_fn(f'resumed from {ckpt_path} at step {i}')
  if it is None:
    if data_factory is None:
      raise ValueError('fit() needs data= or data_factory=')
    it = iter(data_factory(i))
  last_eval_at = None

  def sync_window(i):
    """The window's one host sync, where a wedged device shows: under
    the watchdog when armed; the 'train/sync' span records the wait."""
    stacked = torch.stack([x.reshape(()).float() for x in window])
    window.clear()
    t0 = obs_trace.now()
    if step_timeout_s is None:
      host = stacked.cpu().numpy()
    else:
      host = resilience.call_with_timeout(
          lambda: stacked.cpu().numpy(), step_timeout_s,
          what=f'device-step sync at step {i}')
    sync_s = obs_trace.now() - t0
    obs_trace.complete('train/sync', t0, sync_s, step=i)
    obs_metrics.observe('train.sync_ms', sync_s * 1000.0)
    return host

  def flush(i, final=False):
    nonlocal last_eval_at
    if not window and not final:
      return None
    logs = {}
    if window:
      n_window = len(window)
      host = sync_window(i)
      if on_anomaly is not None:
        # in step order: the first anomalous value names the step
        # (non-finite before spike; a healthy value trains the gate)
        for j, v in enumerate(host):
          step_j = i - n_window + j + 1
          if not np.isfinite(v):
            raise _Anomaly('non_finite_loss', step_j, repr(v))
          if gate is not None:
            z = gate.observe(float(v))
            if z is not None:
              raise _Anomaly(
                  'loss_spike', step_j,
                  f'loss={float(v):.6g} zscore={z:.2f} '
                  f'(gate {gate.zscore:g})')
      mean = float(host.mean())
      logs['loss'] = mean
      history['step'].append(i)
      history['loss'].append(mean)
      obs_metrics.set_gauge('train.loss', mean)
      obs_metrics.journal_snapshot(step=i)
    # the run always ends with an eval of the returned state, once
    if (eval_fn is not None and (i % eval_every == 0 or final)
        and last_eval_at != i):
      evals = eval_fn(state)
      history['eval_step'].append(i)
      for k, v in evals.items():
        kk = 'eval_' + k if k in reserved else k
        logs[kk] = v
        history.setdefault(kk, []).append(v)
      last_eval_at = i
    if not logs:
      return None
    if verbose:
      print_fn('step %d: ' % i +
               ' '.join(f'{k}={v:.6g}' for k, v in logs.items()))
    for cb in callbacks:
      cb(i, state, logs)
    return logs

  rollbacks = 0

  def handle_anomaly(a: _Anomaly) -> bool:
    """Apply the policy to one detection: True after an in-place
    rollback (training goes on), False when the run must stop."""
    nonlocal state, i, it, rollbacks, last_eval_at
    obs_metrics.inc('train.anomalies')
    resilience.journal('anomaly_detected', anomaly=a.kind,
                       step=a.step, policy=on_anomaly, detail=a.detail)
    history.setdefault('anomalies', []).append(
        {'kind': a.kind, 'step': a.step})
    if on_anomaly == 'terminate':
      if a.kind == 'non_finite_loss':
        # the old guard's event name and history key
        resilience.journal('terminate_on_nan', step=a.step,
                           loss=a.detail)
        history['terminated_on_nan'] = a.step
        print_fn(f'terminate_on_nan: non-finite loss at step {a.step}; '
                 'stopping (event journaled to '
                 f'{resilience.journal_path() or "memory"})')
      else:
        history['terminated_on_anomaly'] = a.step
        print_fn(f'on_anomaly=terminate: {a.kind} at step {a.step}; '
                 f'stopping ({a.detail})')
      return False
    if rollbacks >= rollback_budget:
      resilience.journal('rollback_budget_exhausted',
                         budget=rollback_budget, step=a.step,
                         anomaly=a.kind)
      history['terminated_on_anomaly'] = a.step
      history['rollback_budget_exhausted'] = True
      print_fn(f'on_anomaly={on_anomaly}: {a.kind} at step {a.step} '
               f'but the rollback budget ({rollback_budget}) is '
               'exhausted; escalating to termination')
      return False
    from distributed_embeddings_tpu_torch.parallel.checkpoint import (
        restore_train_state)
    try:
      state, path = restore_train_state(dist, state, rollback_dir,
                                        quarantine=True)
    except (FileNotFoundError, ValueError) as e:
      resilience.journal('rollback_failed', step=a.step,
                         anomaly=a.kind, error=str(e))
      history['terminated_on_anomaly'] = a.step
      print_fn(f'on_anomaly={on_anomaly}: {a.kind} at step {a.step} '
               f'and no valid checkpoint to roll back to ({e}); '
               'terminating')
      return False
    rollbacks += 1
    obs_metrics.inc('train.rollbacks')
    to_step = int(state.step)
    detect_at = i
    window.clear()
    last_eval_at = None  # replayed steps evaluate again
    resilience.journal('rollback', anomaly=a.kind, detect_step=a.step,
                       at_step=detect_at, to_step=to_step, path=path,
                       attempt=rollbacks, policy=on_anomaly)
    commsan.record('fit/rollback', anomaly=a.kind, to_step=to_step,
                   attempt=rollbacks)
    if on_anomaly == 'rollback_skip' and detect_at > to_step:
      # batches (to_step, detect_at] never replay
      resilience.journal('skip_window', from_step=to_step,
                         to_step=detect_at,
                         batches=detect_at - to_step)
      commsan.record('fit/skip_window', from_step=to_step,
                     to_step=detect_at)
      it = iter(data_factory(detect_at))
    else:
      it = iter(data_factory(to_step))
    i = to_step
    if verbose:
      print_fn(f'rollback: {a.kind} at step {a.step} -> restored '
               f'{path} at step {to_step} (attempt '
               f'{rollbacks}/{rollback_budget}'
               + (', input fast-forwarded past the offending window'
                  if on_anomaly == 'rollback_skip' else '') + ')')
    return True

  try:
    while True:
      try:
        while steps is None or i < steps:
          try:
            args = next(it)
          except StopIteration:
            break
          if step_timeout_s is not None:
            state, loss = resilience.call_with_timeout(
                lambda s=state, a=args: step_fn(s, *a),
                step_timeout_s, what=f'train step dispatch at step {i}')
          else:
            state, loss = step_fn(state, *args)
          obs_metrics.inc('train.steps')
          commsan.record('fit/step', step=i + 1)
          window.append(loss)
          i += 1
          if auditor is not None and i % auditor.every == 0:
            findings = auditor.check_state(state, step=i)
            if findings:
              raise _Anomaly(
                  'audit_failure', i,
                  '; '.join(f.brief() for f in findings[:3]))
          if i % log_every == 0:
            flush(i, final=(steps == i))
        flush(i, final=True)
        break
      except _Anomaly as a:
        if not handle_anomaly(a):
          break
      except TierIntegrityError as e:
        if on_anomaly is None:
          raise
        if not handle_anomaly(_Anomaly('tier_integrity', i, str(e))):
          break
  except StopIteration:  # raised by a callback: early stop
    pass
  return state, history
