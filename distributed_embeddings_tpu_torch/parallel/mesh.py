"""Device and process-group resolution: the port's counterpart of
``distributed_embeddings_tpu/parallel/mesh.py``.

The JAX package describes its world as a ``jax.sharding.Mesh``; here the
world is one device per process plus an optional ``torch.distributed``
process group.  The world size is the group's size, or 1 without one;
this process's rank is its index in the group, and it plays the part of
the mesh axis index (``jax.lax.axis_index``).

Entry points default to ``device='cuda'``.  Without a card they raise:
they run on the CPU only when the caller passes ``device='cpu'``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.distributed as torch_dist

DEFAULT_DEVICE = 'cuda'
DEFAULT_AXIS = 'data'

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
  """The device an entry point runs on: ``cuda`` unless the caller names
  another.  A CUDA device without a card raises instead of falling back
  to the CPU."""
  dev = torch.device(DEFAULT_DEVICE if device is None else device)
  if dev.type == 'cuda':
    if not torch.cuda.is_available():
      raise RuntimeError(
          f'device {str(dev)!r} requested (the default) but no CUDA '
          "device is available; pass device='cpu' to run the plain "
          'PyTorch path on the CPU')
    if dev.index is None:
      dev = torch.device('cuda', torch.cuda.current_device())
  elif dev.type != 'cpu':
    raise ValueError(f'unsupported device {str(dev)!r}: cuda or cpu')
  return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
  """One flat mesh axis over the processes of ``group``.

  Attributes:
    device: this process's device.
    group: the ``torch.distributed`` process group the tables shard
      over; ``None`` is a world of one.
  """
  device: torch.device
  group: Optional[torch_dist.ProcessGroup] = None

  @property
  def world_size(self) -> int:
    return 1 if self.group is None else torch_dist.get_world_size(self.group)

  @property
  def rank(self) -> int:
    return 0 if self.group is None else torch_dist.get_rank(self.group)


def create_mesh(device: DeviceLike = None,
                group: Optional[torch_dist.ProcessGroup] = None) -> Mesh:
  """A mesh over ``group`` (or a world of one) on ``device``.

  ``group=None`` while ``torch.distributed`` is initialised with more
  than one process takes the default group, so a script launched on
  several ranks shards its tables over all of them."""
  if (group is None and torch_dist.is_available()
      and torch_dist.is_initialized() and torch_dist.get_world_size() > 1):
    group = torch_dist.group.WORLD
  return Mesh(resolve_device(device), group)


def init_distributed(init_method: str, world_size: int, rank: int,
                     backend: Optional[str] = None,
                     device: DeviceLike = None) -> Mesh:
  """Join a ``world_size``-process world (the ``hvd.init()`` analog):
  ``init_method`` is the rendezvous address (``tcp://localhost:<port>``),
  ``backend`` defaults to NCCL on CUDA and gloo on the CPU.  CUDA ranks
  take card ``rank % device_count`` unless ``device`` names one."""
  if device is None and torch.cuda.is_available():
    device = f'cuda:{rank % torch.cuda.device_count()}'
  dev = resolve_device(device)
  if dev.type == 'cuda':
    torch.cuda.set_device(dev)
  backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
  torch_dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
  return Mesh(dev, torch_dist.group.WORLD if world_size > 1 else None)
