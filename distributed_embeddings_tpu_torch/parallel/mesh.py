"""Device and process-group resolution: the port's counterpart of
``distributed_embeddings_tpu/parallel/mesh.py``.

The JAX package describes its world as a ``jax.sharding.Mesh``; here the
world is one device per process plus an optional ``torch.distributed``
process group.  The world size is the group's size, or 1 without one;
this process's rank is its index in the group, and it plays the part of
the mesh axis index (``jax.lax.axis_index``).  A two-axis ``(dcn,
data)`` mesh (``create_mesh(shape=(S, D))``) adds a process group per
axis: the data axis's (a slice's processes) and the dcn axis's (the
processes of one data index across slices), over the world.

Entry points default to ``device='cuda'``.  Without a card they raise:
they run on the CPU only when the caller passes ``device='cpu'``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as torch_dist

DEFAULT_DEVICE = 'cuda'
DEFAULT_AXIS = 'data'
DCN_AXIS = 'dcn'

# the link an axis rides: the outer axis of a two-axis mesh crosses the
# data-center network, every other axis the intra-slice link
LINK_ICI = 'ici'
LINK_DCN = 'dcn'

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
  """The processes the tables shard over: one flat ``data`` axis, or a
  two-axis ``(dcn, data)`` mesh of ``S`` slices of ``D`` processes
  (``create_mesh(shape=(S, D))``, docs/design.md §20).

  Process ``s * D + d`` of the world sits at ``(slice s, data d)``, as a
  JAX mesh built by ``create_mesh((S, D))`` places its devices.  On a
  two-axis mesh ``world_size`` and ``rank`` are the DATA axis's (the JAX
  layer's ``world_size`` is its inner axis too): the tables shard over
  ``group`` and replicate across slices, or with ``dcn_sharding`` shard
  over the product; the batch splits over the product in rank order.

  Attributes:
    device: this process's device.
    group: the ``data`` axis's process group (this slice's ``D``
      processes); ``None`` is a data axis of one.
    dcn_group: the ``dcn`` axis's group (the ``S`` processes with this
      data index); ``None`` on a flat mesh.
    world_group: the group of the axis product (the world) on a
      two-axis mesh; ``None`` on a flat mesh, where it is ``group``.
    shape: ``(S, D)`` of a two-axis mesh, ``None`` for a flat one.
  """
  device: torch.device
  group: Optional[torch_dist.ProcessGroup] = None
  dcn_group: Optional[torch_dist.ProcessGroup] = None
  world_group: Optional[torch_dist.ProcessGroup] = None
  shape: Optional[Tuple[int, int]] = None

  @property
  def axis_names(self) -> Tuple[str, ...]:
    return (DCN_AXIS, DEFAULT_AXIS) if self.shape else (DEFAULT_AXIS,)

  @property
  def world_size(self) -> int:
    """The data axis's size (the whole world on a flat mesh)."""
    return 1 if self.group is None else torch_dist.get_world_size(self.group)

  @property
  def rank(self) -> int:
    """This process's index on the data axis."""
    return 0 if self.group is None else torch_dist.get_rank(self.group)

  @property
  def num_slices(self) -> int:
    return self.shape[0] if self.shape else 1

  @property
  def slice_index(self) -> int:
    """This process's index on the dcn axis (0 on a flat mesh)."""
    return (0 if self.dcn_group is None
            else torch_dist.get_rank(self.dcn_group))

  @property
  def product_group(self) -> Optional[torch_dist.ProcessGroup]:
    """The group of every process of the mesh (the axis product)."""
    return self.world_group if self.shape else self.group

  @property
  def product_size(self) -> int:
    return self.num_slices * self.world_size

  @property
  def product_rank(self) -> int:
    """``slice * D + data``: this process's block of the batch."""
    return self.slice_index * self.world_size + self.rank


def axis_link(mesh: Mesh, axis_name: str) -> str:
  """Link kind of one mesh axis: the OUTER axis of a two-axis mesh
  crosses the data-center network (``'dcn'``), the inner one (and the
  one axis of a flat mesh) rides the intra-slice link (``'ici'``)."""
  names = mesh.axis_names
  if axis_name not in names:
    raise ValueError(f'axis {axis_name!r} not in mesh axes {names}')
  if len(names) > 1 and axis_name == names[0]:
    return LINK_DCN
  return LINK_ICI


def mesh_link_info(mesh: Mesh) -> dict:
  """``{axis_name: link_kind}`` for every axis of ``mesh``."""
  return {a: axis_link(mesh, a) for a in mesh.axis_names}


def batch_sharding(mesh: Mesh, global_batch: int) -> slice:
  """The block of a global batch this process holds: the batch splits
  over the slice x data product in rank order, so process ``(s, d)``
  holds samples ``[(s * D + d) * B, (s * D + d + 1) * B)``, ``B =
  global_batch / (S * D)`` (the JAX package's ``batch_sharding``)."""
  n = mesh.product_size
  if global_batch % n:
    raise ValueError(f'global batch {global_batch} does not split over '
                     f'{n} processes')
  b = global_batch // n
  return slice(mesh.product_rank * b, (mesh.product_rank + 1) * b)


def _axis_groups(shape: Sequence[int]):
  """This process's ``(data group, dcn group)`` of an ``(S, D)`` mesh.
  Every process creates every group, in the same order (``new_group``
  is collective over the world)."""
  S, D = shape
  me = torch_dist.get_rank()
  data = dcn = None
  for s in range(S):
    g = torch_dist.new_group(ranks=[s * D + d for d in range(D)])
    if me // D == s:
      data = g
  for d in range(D):
    g = torch_dist.new_group(ranks=[s * D + d for s in range(S)])
    if me % D == d:
      dcn = g
  return data, dcn


def create_mesh(device: DeviceLike = None,
                group: Optional[torch_dist.ProcessGroup] = None,
                shape: Optional[Sequence[int]] = None) -> Mesh:
  """A mesh over ``group`` (or a world of one) on ``device``; with
  ``shape=(S, D)`` a two-axis ``(dcn, data)`` mesh over the initialised
  world of ``S * D`` processes (``create_mesh((S, D))`` of the JAX
  package): the outer axis spans slices, the inner one a slice's
  processes.  Every process of the world must call it with the same
  shape (it creates the axes' process groups).

  ``group=None`` while ``torch.distributed`` is initialised with more
  than one process takes the default group, so a script launched on
  several ranks shards its tables over all of them."""
  dev = resolve_device(device)
  if shape is not None:
    shape = tuple(int(x) for x in shape)
    if len(shape) > 2:
      raise ValueError(
          f'mesh may have at most one extra (DCN/slice) axis besides '
          f'{DEFAULT_AXIS!r}, got a {len(shape)}-axis shape {shape}')
    if len(shape) == 2:
      if group is not None:
        raise ValueError('create_mesh takes a group or a two-axis shape, '
                         'not both')
      world = (torch_dist.get_world_size() if torch_dist.is_available()
               and torch_dist.is_initialized() else 1)
      if shape[0] * shape[1] != world:
        raise ValueError(f'create_mesh(shape={shape}) needs '
                         f'{shape[0] * shape[1]} processes, the world has '
                         f'{world}')
      data, dcn = _axis_groups(shape)
      return Mesh(dev, data if shape[1] > 1 else None, dcn,
                  torch_dist.group.WORLD, shape)
  if (group is None and torch_dist.is_available()
      and torch_dist.is_initialized() and torch_dist.get_world_size() > 1):
    group = torch_dist.group.WORLD
  return Mesh(dev, group)


def init_distributed(init_method: str, world_size: int, rank: int,
                     backend: Optional[str] = None,
                     device: DeviceLike = None,
                     mesh_shape: Optional[Sequence[int]] = None) -> Mesh:
  """Join a ``world_size``-process world (the ``hvd.init()`` analog):
  ``init_method`` is the rendezvous address (``tcp://localhost:<port>``
  or ``file://<path>``), ``backend`` defaults to NCCL on CUDA and gloo
  on the CPU.  CUDA ranks take card ``rank % device_count`` unless
  ``device`` names one.  ``mesh_shape=(S, D)`` (``S * D ==
  world_size``) returns the two-axis mesh, built in the same order on
  every rank; otherwise one flat axis over the world."""
  if device is None and torch.cuda.is_available():
    device = f'cuda:{rank % torch.cuda.device_count()}'
  dev = resolve_device(device)
  if dev.type == 'cuda':
    torch.cuda.set_device(dev)
  backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
  torch_dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
  if mesh_shape is not None and len(tuple(mesh_shape)) > 1:
    return create_mesh(dev, shape=mesh_shape)
  return Mesh(dev, torch_dist.group.WORLD if world_size > 1 else None)
