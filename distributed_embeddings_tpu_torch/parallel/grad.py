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

``fit``, its resume/rollback/audit machinery and the dense autodiff
trainer ``make_train_step`` are ROADMAP.md Queue 1 items.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch
import torch.distributed as torch_dist


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
