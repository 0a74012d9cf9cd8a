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
same gradients for a loop of the caller's own.  ``fit`` and its
resume/rollback/audit machinery are ROADMAP.md Queue 1, item 3c.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch import optim


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

  Args:
    loss_fn: the local-mean loss.
    group: the process group the tables shard over (the model's
      ``dist_embedding.mesh.group``); default: the world, or a world of
      one without ``torch.distributed``.
  """

  def __init__(self, loss_fn: Callable,
               group: Optional[torch_dist.ProcessGroup] = None):
    self._loss_fn = loss_fn
    self.group = _default_group(group)

  def value_and_gradient(self, params, *args, **kwargs):
    """``(global-mean loss, grads)``: grads a tree of ``params``'
    structure, the loss a detached 0-d tensor."""
    world = _world(self.group)
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
    if world > 1:
      for g in optim.tree_leaves(grads.get('embedding', {})):
        g.div_(world)
    return loss, grads

  def gradient(self, params, *args, **kwargs):
    return self.value_and_gradient(params, *args, **kwargs)[1]


def make_train_step(loss_fn: Callable, optimizer,
                    group: Optional[torch_dist.ProcessGroup] = None
                    ) -> Callable:
  """Build the dense autodiff train step (JAX ``make_train_step``).

  Args:
    loss_fn: ``loss_fn(params, batch) -> scalar``, the mean loss over
      this rank's LOCAL batch; ``params`` is ``{'embedding': this rank's
      group tables, **dense params}``.  The step turns it into the JAX
      package's global mean (``DistributedGradientTape``).
    optimizer: a port ``GradientTransformation`` (``optim.sgd``,
      ``optim.adagrad``), applied to every param, tables included.
    group: as in ``DistributedGradientTape``.

  Returns:
    ``step(state: TrainState, batch) -> (TrainState, loss)``, ``loss``
    the global mean (a 0-d tensor).  The params are updated IN PLACE
    (under ``torch.no_grad()``), as the JAX step's donated buffers are
    reused: the returned state holds the same tensors.
  """
  tape = DistributedGradientTape(loss_fn, group)

  def step(state: TrainState, batch):
    loss, grads = tape.value_and_gradient(state.params, batch)
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
