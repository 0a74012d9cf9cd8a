"""The multi-rank serving front end: one front door admits, every rank of
a replica looks up its block, the answers are gathered back to the front
door.  The JAX package has no counterpart: its single controller sees a
global output.

A ``ServingEngine`` on several ranks answers only its own rank's block
of a rung (``mesh.batch_sharding``).  A replica's ranks and the front
door (the rank that holds the pool, world rank ``FRONT_DOOR``, 0) share
a LINK: a gloo control group over the front door and the replica's ranks.
``RankFrontEnd(engine)`` is built on every rank of an
engine over the whole world, in the same order (it creates the control
group, as ``DistributedEmbedding`` creates its tier groups).

Replicas on disjoint rank sets: each replica's engine sits on a mesh over
its own ranks (``mesh.create_mesh(ranks=[...])``), and
``replica_front_ends(engines, layout)``, called on EVERY
process of the world in one order (``new_group`` is collective over the
world), gives each replica a link of its own.  A replica of one rank on
the front door needs none: the pool takes its bare engine.  Where the
front door is not among a replica's ranks it holds a ``ReplicaView`` of
the replica's engine (its host side, which the replica's first rank
sends over the link), contributes no block to the answers, and passes
gloo's gather a dummy block of the right size, which it drops.

On the front door a front end stands in for the engine: it offers the
surface ``DynamicBatcher``, ``ServingEnginePool`` and ``serving/bench.py``
read, and its ``lookup`` / ``lookup_padded`` return the WHOLE rung's
answers as f32 host tensors.  Per batch, under the link's lock:

1. the front door validates and pads on the host, as the engine does, so
   a request that would fail fails there, before anything is sent;
2. ONE broadcast from the front door over the control group carries a
   fixed-size int32 buffer: a header (op, replica, rung, real samples,
   sequence number) and the rung's padded ids, ``batch_size x
   sum(hotness)`` of them;
3. every rank of the replica runs its engine on its block (the engine's
   own exchange stays on the mesh's group: NCCL across cards, gloo for
   ranks that share one);
4. ONE gather to the front door: each rank's block as one flat f32
   buffer (``batcher.host_flat``), put back in product-rank order.

The lock makes every batch reach every rank of the link in one order,
whichever thread sent it (a batcher's executor, the no-batching arm,
``warmup``, each replica's batcher); links do not share it, so replicas
on disjoint rank sets run their batches side by side.  The broadcast and
the gather run inside the front door's ``'serve/lookup'`` span, so inside
``'serve/execute'`` when a batcher sends.  An empty request resolves on
the front door with no broadcast.  ``warmup`` runs through the front
end: a rank that warmed its engine alone would issue collectives the
others do not match.

Replicas of one link: ``fe.replica(engine2)`` (on every rank of the
link, in one order; ``None`` on a front door outside the replica) adds an
engine over the SAME ranks to the same link, under the next replica
index, which the header names; a pool of such front ends serves with the
pool's semantics.

On every other rank ``serve_forever()`` runs the batches until the front
door's ``close()`` broadcasts ``stop``, then returns this rank's counts.
A follower waits for the next batch as long as the front door idles (its
control group's timeout is ``FOLLOWER_TIMEOUT_S``); the front door's
waits end after ``LEADER_TIMEOUT_S``.  A follower whose lookup (or link)
fails writes the error to its stderr and ends its process with
``FOLLOWER_FAULT_EXIT``; the front door sees that as an error on the
control group or the mesh's group, fails that batch and every later
lookup of the link with ``ReplicaLostError`` (it never answers from its
own block alone), and tears down its end of that link's control group,
so every other follower's wait on it fails at once and ends that
follower too.  A fault in the front door's own block after the
broadcast does the same.  Other links are untouched: a pool routes
around the lost replica and retries its requests on the others.  A
follower still inside the engine's exchange waits out the mesh group's
timeout (over NCCL, its watchdog); nothing on the front door waits for
it.
"""

from __future__ import annotations

import datetime
import os
import sys
import threading
import traceback

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.serving.batcher import (
    ReplicaLostError, host_flat)
from distributed_embeddings_tpu_torch.serving.engine import ReplicaView

# the control buffer's header: op, replica, rung, real samples, sequence
HEADER = 5
OP_STOP, OP_LOOKUP = 0, 1
# the control group's timeout: the front door waits only for a batch's
# blocks; a follower waits for the next batch however long the front
# door idles
LEADER_TIMEOUT_S = 300.0
FOLLOWER_TIMEOUT_S = 365 * 24 * 3600.0
FOLLOWER_FAULT_EXIT = 3
# the world rank that holds the pool and admits requests
FRONT_DOOR = 0


def _engine_ranks(engine) -> List[int]:
  """The world ranks of an engine's mesh, in product-rank order (a flat
  mesh's group and a two-axis mesh's world are both in rank order)."""
  group = engine.dist.mesh.product_group
  if group is None:
    return [torch_dist.get_rank()]
  return sorted(torch_dist.get_process_group_ranks(group))


def _control_group(members: Sequence[int]):
  """The gloo control group over ``members`` (every process of the world
  calls this, in one order)."""
  timeout = (LEADER_TIMEOUT_S if torch_dist.get_rank() == FRONT_DOOR
             else FOLLOWER_TIMEOUT_S)
  return torch_dist.new_group(list(members), backend='gloo',
                              timeout=datetime.timedelta(seconds=timeout))


class _Link:
  """One replica's control group and everything the engines on its
  ranks share: the lock, the sequence number, the engines by replica
  index (``ReplicaView``s on a front door outside the ranks), the counts
  and the lost state."""

  def __init__(self, pg, ranks: Sequence[int]):
    self.pg = pg
    self.rank = torch_dist.get_rank()
    self.ranks = tuple(ranks)  # product-rank order
    self.world = len(self.ranks)
    # the control group's ranks, in its rank order (gather's parts)
    self.members = tuple(sorted(set(self.ranks) | {FRONT_DOOR}))
    self.holds_block = FRONT_DOOR in self.ranks
    self.engines: List = []
    self.lock = threading.Lock()
    self.seq = 0
    self.lost: Optional[BaseException] = None
    self.closed = False
    self.batches = 0
    self.samples = 0
    self.broadcast_ms = 0.0
    self.gather_ms = 0.0

  def add(self, engine) -> tuple:
    """Add a replica's engine (every rank of the link, in one order; on a
    front door outside the replica's ranks the replica's first rank
    sends its engine's host side, which becomes a ``ReplicaView``):
    returns its replica index and its engine on this rank."""
    if not self.holds_block:
      box = [engine.host_spec() if self.rank == self.ranks[0] else None]
      torch_dist.broadcast_object_list(box, src=self.ranks[0],
                                       group=self.pg)
      if self.rank == FRONT_DOOR:
        engine = ReplicaView(box[0])
    shape = (engine.batch_size, tuple(engine.hotness),
             tuple(engine.output_dims))
    if not self.engines:
      self.batch_size, self.hotness, self.output_dims = shape
      self.buf = torch.zeros(HEADER + self.batch_size * sum(self.hotness),
                             dtype=torch.int32)
    elif shape != (self.batch_size, self.hotness, self.output_dims):
      raise ValueError(
          'a replica must match its link\'s batch, hotness and output '
          f'widths: {shape} vs {(self.batch_size, self.hotness)}, '
          f'{self.output_dims}')
    self.engines.append(engine)
    return len(self.engines) - 1, engine

  # -------------------------------------------------------- front door

  def _send(self, op: int, replica: int = 0, rung: int = 0,
            samples: int = 0, padded=None):
    """One broadcast of the control buffer (the caller holds the
    lock)."""
    arr = self.buf.numpy()
    arr[:HEADER] = (op, replica, rung, samples, self.seq)
    off = HEADER
    for x in padded or ():
      flat = np.asarray(x, np.int32).reshape(-1)
      arr[off:off + flat.size] = flat
      off += flat.size
    torch_dist.broadcast(self.buf, src=FRONT_DOOR, group=self.pg)

  def check_alive(self):
    if self.lost is not None:
      raise ReplicaLostError(
          f'the serving front end lost a rank of its replica on ranks '
          f'{list(self.ranks)}: {self.lost!r}') from self.lost
    if self.closed:
      raise RuntimeError('the serving front end is closed')

  def run(self, replica: int, padded, b: int, real: int
          ) -> List[torch.Tensor]:
    """One batch across the replica's ranks: broadcast, every rank's
    block, gather; the whole rung's answers as f32 host tensors."""
    engine = self.engines[replica]
    with self.lock:
      self.check_alive()
      self.seq += 1
      t0 = obs_trace.now()
      try:
        self._send(OP_LOOKUP, replica, b, real, padded)
        t1 = obs_trace.now()
        if self.holds_block:
          flat = host_flat(engine.apply_block(padded, b))
        else:
          # gloo gathers a block from every member, the root included
          flat = torch.empty(b // self.world * sum(self.output_dims))
        parts = [torch.empty_like(flat) for _ in self.members]
        t2 = obs_trace.now()
        torch_dist.gather(flat, parts, dst=FRONT_DOOR, group=self.pg)
        t3 = obs_trace.now()
      except Exception as e:
        self._abort(e)
        raise ReplicaLostError(
            f'serving batch {self.seq} (rung {b}) failed across the '
            f'replica on ranks {list(self.ranks)}: {e!r}') from e
      finally:
        lookup_ms = (obs_trace.now() - t0) * 1000.0
        obs_trace.complete('serve/lookup', t0, lookup_ms / 1000.0, batch=b)
      self.batches += 1
      self.samples += real
      self.broadcast_ms += (t1 - t0) * 1000.0
      self.gather_ms += (t3 - t2) * 1000.0
    engine.count_lookup(b, real, lookup_ms)
    blocks = dict(zip(self.members, parts))
    return self._assemble([blocks[r] for r in self.ranks], b)

  def _assemble(self, parts, b: int) -> List[torch.Tensor]:
    """Each input's ``[b, output_dim]`` answer from the ranks' flat
    blocks, in product-rank order: views, back to back, of ONE host
    buffer in ``host_outputs``'s layout (which then copies nothing)."""
    blk = b // self.world
    flat = torch.empty(b * sum(self.output_dims))
    outs = []
    src = dst = 0
    for d in self.output_dims:
      out = flat[dst:dst + b * d].view(b, d)
      for r, p in enumerate(parts):
        out[r * blk:(r + 1) * blk] = p[src:src + blk * d].view(blk, d)
      outs.append(out)
      src += blk * d
      dst += b * d
    return outs

  def _abort(self, e: BaseException):
    """Mark the link lost and destroy this rank's end of its control
    group (on the front door the caller holds the lock): its sockets
    close, so a rank waiting on it (a gather, the next broadcast) fails
    at once, a follower instead of waiting out ``FOLLOWER_TIMEOUT_S``.
    Other links are untouched."""
    self.lost = e
    pg, self.pg = self.pg, None
    try:
      torch_dist.destroy_process_group(pg)
    except (RuntimeError, ValueError):
      # a group the fault already broke, or one destroyed before: the
      # batch's own error is the one raised
      pass

  def close(self):
    """Broadcast ``stop`` (none on a lost link); idempotent."""
    with self.lock:
      if self.closed:
        return
      self.closed = True
      if self.lost is None:
        try:
          self.seq += 1
          self._send(OP_STOP)
        except Exception as e:
          self._abort(e)

  # ---------------------------------------------------------- follower

  def serve(self) -> dict:
    """The follower's loop; returns its counts at ``stop``."""
    arr = self.buf.numpy()
    by_replica = [0] * len(self.engines)
    while True:
      torch_dist.broadcast(self.buf, src=FRONT_DOOR, group=self.pg)
      op, replica, b, real, seq = (int(v) for v in arr[:HEADER])
      if seq != self.seq + 1:
        raise RuntimeError(f'control buffer out of order: sequence {seq} '
                           f'after {self.seq}')
      self.seq = seq
      if op == OP_STOP:
        break
      if op != OP_LOOKUP or not 0 <= replica < len(self.engines):
        raise RuntimeError(f'bad control header {arr[:HEADER].tolist()}')
      padded = []
      off = HEADER
      for h in self.hotness:
        x = arr[off:off + b * h].copy()
        padded.append(x if h == 1 else x.reshape(b, h))
        off += b * h
      flat = host_flat(self.engines[replica].lookup(padded, samples=real))
      torch_dist.gather(flat, None, dst=FRONT_DOOR, group=self.pg)
      self.batches += 1
      self.samples += real
      by_replica[replica] += 1
    self.closed = True
    return {'rank': self.rank, 'batches': self.batches,
            'samples': self.samples, 'by_replica': by_replica}


class RankFrontEnd:
  """The engine surface of a replica's ranks on the front door; the
  batch loop on its followers (see the module docstring).

  Args:
    engine: this rank's ``ServingEngine``.

  Built directly, the control group spans the front door and the
  engine's ranks, which must then be the whole world (every process
  calls ``new_group``).  Replicas on disjoint rank sets are built by
  ``replica_front_ends``, which gives a front door outside a replica's
  ranks its end (``engine=None``).
  """

  def __init__(self, engine, *, _ranks=None, _pg=None, _link=None):
    if not (torch_dist.is_available() and torch_dist.is_initialized()):
      raise ValueError('RankFrontEnd needs an initialised process group '
                       '(mesh.init_distributed)')
    me = torch_dist.get_rank()
    ranks = _ranks
    if _link is not None:
      ranks = list(_link.ranks)
    if engine is not None:
      if _link is not None and _engine_ranks(engine) != ranks:
        raise ValueError(f'a replica on ranks {_engine_ranks(engine)} '
                         f'cannot share the link of ranks {ranks}')
      ranks = _engine_ranks(engine)
      if engine.dist.mesh.product_rank != ranks.index(me):
        raise ValueError(
            f'rank {me} is product rank {engine.dist.mesh.product_rank} '
            f'of its mesh, not {ranks.index(me)}: a front end gathers '
            'the blocks in the order of the mesh\'s world ranks')
    elif ranks is None or me != FRONT_DOOR or me in ranks:
      raise ValueError('RankFrontEnd needs this rank\'s engine (a front '
                       'door outside a replica\'s ranks gets its end from '
                       'replica_front_ends)')
    ranks = sorted(int(r) for r in ranks)
    if ranks == [FRONT_DOOR]:
      raise ValueError('an engine of one rank on the front door needs no '
                       'RankFrontEnd: give the pool the engine itself')
    if _link is None:
      if _pg is None:
        members = sorted(set(ranks) | {FRONT_DOOR})
        if members != list(range(torch_dist.get_world_size())):
          raise ValueError(
              f'a front end over ranks {ranks} with front door '
              f'{FRONT_DOOR} leaves ranks of the world of '
              f'{torch_dist.get_world_size()} out of its control group, '
              'whose new_group every process must call: build replicas '
              'on disjoint rank sets with serving.replica_front_ends on '
              'every process')
        _pg = _control_group(members)
      _link = _Link(_pg, ranks)
    self._link = _link
    self.replica_index, self.engine = _link.add(engine)

  def replica(self, engine) -> 'RankFrontEnd':
    """A front end for another engine over the same ranks (a replica of
    a pool), sharing this one's link; call it on every rank of the link
    in one order (with ``None`` on a front door outside the ranks)."""
    return RankFrontEnd(engine, _link=self._link)

  # ------------------------------------------------------------ surface

  @property
  def link(self):
    """The link this front end shares with the replicas on its ranks."""
    return self._link

  @property
  def rank(self) -> int:
    return self._link.rank

  @property
  def is_leader(self) -> bool:
    """True on the front door, the one rank that admits requests."""
    return self._link.rank == FRONT_DOOR

  @property
  def batch_size(self) -> int:
    return self.engine.batch_size

  @property
  def buckets(self):
    return self.engine.buckets

  @property
  def hotness(self):
    return self.engine.hotness

  @property
  def output_dims(self):
    return self.engine.output_dims

  def bucket_for(self, n: int) -> int:
    return self.engine.bucket_for(n)

  def load_kernels(self) -> 'RankFrontEnd':
    self.engine.load_kernels()
    return self

  def hot_only_filter(self, cats):
    """The degraded mode's filter, on the front door before the
    broadcast (the broadcast carries the ids it kept)."""
    return self.engine.hot_only_filter(cats)

  @property
  def hot_filter_available(self) -> bool:
    return self.engine.hot_filter_available

  def _leader_only(self, what: str):
    if not self.is_leader:
      raise RuntimeError(
          f'{what} on follower rank {self.rank}: only the front door, '
          f'rank {FRONT_DOOR}, admits requests; a follower runs '
          'serve_forever()')

  def lookup(self, cats, samples: Optional[int] = None
             ) -> List[torch.Tensor]:
    """``ServingEngine.lookup`` across the replica's ranks: the
    per-input ``[rung, output_dim]`` answers of the WHOLE rung, f32 on
    the host."""
    self._leader_only('lookup')
    cats = list(cats)
    b, real = self.engine.check_rung(cats, samples)
    padded = [self.engine.pad_input(i, x, b) for i, x in enumerate(cats)]
    return self._link.run(self.replica_index, padded, b, real)

  def lookup_padded(self, cats) -> List[torch.Tensor]:
    """One request through the smallest rung that holds it; an empty one
    resolves here, with no broadcast."""
    self._leader_only('lookup_padded')
    cats = list(cats)
    n = int(np.asarray(cats[0]).shape[0]) if cats else 0
    if n == 0:
      return [torch.zeros((0, d)) for d in self.output_dims]
    bucket = self.bucket_for(n)
    padded = [self.engine.pad_input(i, x, bucket)
              for i, x in enumerate(cats)]
    return [o[:n] for o in self.lookup(padded, samples=n)]

  def warmup(self, sample_cats=None, seed: int = 0) -> 'RankFrontEnd':
    """Every rung once, through the front end (idempotent)."""
    self._leader_only('warmup')
    self.engine.warmup(sample_cats, seed, lookup_padded=self.lookup_padded)
    return self

  def stats(self) -> dict:
    """The engine's stats plus a ``front_end`` block: the replica's rank
    count and ranks, the batches its link ran (every replica's on it),
    the broadcast and gather ms summed over them, and whether a rank was
    lost."""
    link = self._link
    with link.lock:
      block = {'world_size': link.world, 'ranks': list(link.ranks),
               'replicas': len(link.engines),
               'batches': link.batches, 'samples': link.samples,
               'broadcast_ms': round(link.broadcast_ms, 3),
               'gather_ms': round(link.gather_ms, 3),
               'lost': link.lost is not None}
    return {**self.engine.stats(), 'front_end': block}

  # ---------------------------------------------------------- lifecycle

  def serve_forever(self) -> dict:
    """A follower's loop: run every batch the front door broadcasts until
    it closes; returns ``{'rank', 'batches', 'samples', 'by_replica'}``.
    A fault tears down this rank's end of the control group, is written
    to stderr and ends the process with ``FOLLOWER_FAULT_EXIT`` (the
    front door sees the rank go)."""
    if self.is_leader:
      raise RuntimeError('serve_forever runs on the follower ranks; the '
                         'front door admits requests')
    for e in self._link.engines:
      e.load_kernels()
    try:
      return self._link.serve()
    except Exception as e:
      # this rank's end of the control group closes first: the front
      # door's wait on it fails now, not once the process has unmapped
      # its memory (no operation of the group is in flight here)
      self._link._abort(e)
      print(f'serving front end: follower rank {self.rank} failed after '
            f'{self._link.batches} batch(es):', file=sys.stderr)
      traceback.print_exc()
      sys.stdout.flush()
      sys.stderr.flush()
      os._exit(FOLLOWER_FAULT_EXIT)

  def close(self):
    """The front door's shutdown: broadcast ``stop`` to every follower of
    the link (none after a lost rank).  Idempotent; run it after closing
    the batcher or pool that uses this front end.  Closes every replica
    of the link."""
    self._leader_only('close')
    self._link.close()


def replica_front_ends(engines, layout) -> list:
  """Front ends of replicas on disjoint rank sets, one link each; call it
  on EVERY process of the world, in one order, with the same ``layout``.

  Args:
    engines: by replica, this process's engine (on the replica's ranks,
      its mesh from ``create_mesh(ranks=layout[i])``) or ``None``.
    layout: by replica, its world ranks; the sets are disjoint.

  Returns, by replica: this process's ``RankFrontEnd`` (the front door's
  admits, a follower's runs ``serve_forever``), the bare engine of a
  replica of one rank on the front door (the pool takes it as it is),
  or ``None`` where this process is neither of the replica's ranks nor
  its front door."""
  engines, layout = list(engines), [sorted(int(r) for r in rs)
                                    for rs in layout]
  me = torch_dist.get_rank()
  seen = [r for rs in layout for r in rs]
  if len(engines) != len(layout) or len(set(seen)) != len(seen):
    raise ValueError(f'replica_front_ends: {len(engines)} engines for the '
                     f'layout {layout}, whose rank sets must be disjoint')
  out = []
  for engine, ranks in zip(engines, layout):
    if (engine is not None) != (me in ranks):
      raise ValueError(f'rank {me}: an engine is given exactly for the '
                       f'replicas it is a rank of, not for {ranks}')
    if ranks == [FRONT_DOOR]:
      out.append(engine)
      continue
    members = sorted(set(ranks) | {FRONT_DOOR})
    pg = _control_group(members)
    if me not in members:
      out.append(None)
      continue
    out.append(RankFrontEnd(engine, _ranks=ranks, _pg=pg))
  return out
