"""The multi-rank serving front end: one leader admits, every rank looks
up its block, the answers are gathered back to the leader.  The JAX
package has no counterpart: its single controller sees a global output.

A ``ServingEngine`` on several ranks answers only its own rank's block
of a rung (``mesh.batch_sharding``).  ``RankFrontEnd(engine)`` is built
on EVERY rank of the engine's world, in the same order (it creates a
gloo control group over the world, as ``DistributedEmbedding`` creates
its tier groups).

On the leader (product rank 0) it stands in for the engine: it offers
the surface ``DynamicBatcher``, ``ServingEnginePool`` and
``serving/bench.py`` read, and its ``lookup`` / ``lookup_padded`` return
the WHOLE rung's answers as f32 host tensors.  Per batch, under one
lock:

1. the leader validates and pads on the host, as the engine does, so a
   request that would fail fails there, before anything is sent;
2. ONE broadcast over the control group carries a fixed-size int32
   buffer: a header (op, replica, rung, real samples, sequence number)
   and the rung's padded ids, ``batch_size x sum(hotness)`` of them;
3. every rank runs its engine on its block (the engine's own exchange
   stays on the mesh's group: NCCL across cards, gloo for ranks that
   share one);
4. ONE gather to the leader: each rank's block as one flat f32 buffer
   (``batcher.host_flat``), put back in product-rank order.

The lock makes every batch reach every rank in one order, whichever
thread sent it (a batcher's executor, the no-batching arm, ``warmup``,
each replica's batcher).  The broadcast and the gather run inside the
leader's ``'serve/lookup'`` span, so inside ``'serve/execute'`` when a
batcher sends.  An empty request resolves on the leader with no
broadcast.  ``warmup`` runs through the front end: a rank that warmed
its engine alone would issue collectives the others do not match.

Replicas: ``fe.replica(engine2)`` (on every rank, in one order) adds an
engine over the SAME world to the same link, under the next replica
index, which the header names; a pool of such front ends serves with
the pool's semantics.  Replicas on disjoint rank sets refuse
(``not_ported``, item 17).

On every other rank ``serve_forever()`` runs the batches until the
leader's ``close()`` broadcasts ``stop``, then returns this rank's
counts.  A follower waits for the next batch as long as the leader
idles (its control group's timeout is ``FOLLOWER_TIMEOUT_S``); the
leader's waits end after ``LEADER_TIMEOUT_S``.  A follower whose lookup
(or link) fails writes the error to its stderr and ends its process with
``FOLLOWER_FAULT_EXIT``; the leader sees that as an error on the control
group or the mesh's group, fails that batch and every later lookup with
``ReplicaLostError`` (it never answers from its own block alone), and
tears down its end of the control group, so every other follower's wait
on it fails at once and ends that follower too.  A fault in the leader's
own block after the broadcast does the same.  A follower still inside
the engine's exchange waits out the mesh group's timeout (over NCCL, its
watchdog).
"""

from __future__ import annotations

import datetime
import os
import sys
import threading
import traceback

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    not_ported)
from distributed_embeddings_tpu_torch.serving.batcher import (
    MULTI_RANK_ITEM, ReplicaLostError, host_flat)

# the control buffer's header: op, replica, rung, real samples, sequence
HEADER = 5
OP_STOP, OP_LOOKUP = 0, 1
# the control group's timeout: the leader waits only for a batch's
# blocks; a follower waits for the next batch however long the leader
# idles
LEADER_TIMEOUT_S = 300.0
FOLLOWER_TIMEOUT_S = 365 * 24 * 3600.0
FOLLOWER_FAULT_EXIT = 3


class _Link:
  """The world's control group and everything the replicas of one world
  share: the lock, the sequence number, the engines by replica index,
  the counts and the lost state."""

  def __init__(self, engine):
    self.world = torch_dist.get_world_size()
    self.rank = torch_dist.get_rank()
    timeout = LEADER_TIMEOUT_S if self.rank == 0 else FOLLOWER_TIMEOUT_S
    self.pg = torch_dist.new_group(
        list(range(self.world)), backend='gloo',
        timeout=datetime.timedelta(seconds=timeout))
    self.batch_size = engine.batch_size
    self.hotness = tuple(engine.hotness)
    self.output_dims = tuple(engine.output_dims)
    self.buf = torch.zeros(HEADER + self.batch_size * sum(self.hotness),
                           dtype=torch.int32)
    self.engines: List = []
    self.lock = threading.Lock()
    self.seq = 0
    self.lost: Optional[BaseException] = None
    self.closed = False
    self.batches = 0
    self.samples = 0
    self.broadcast_ms = 0.0
    self.gather_ms = 0.0

  # ------------------------------------------------------------ leader

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
    torch_dist.broadcast(self.buf, src=0, group=self.pg)

  def check_alive(self):
    if self.lost is not None:
      raise ReplicaLostError(
          f'the serving front end lost a rank of its world of '
          f'{self.world}: {self.lost!r}') from self.lost
    if self.closed:
      raise RuntimeError('the serving front end is closed')

  def run(self, replica: int, padded, b: int, real: int
          ) -> List[torch.Tensor]:
    """One batch across the world: broadcast, every rank's block,
    gather; the whole rung's answers as f32 host tensors."""
    engine = self.engines[replica]
    with self.lock:
      self.check_alive()
      self.seq += 1
      t0 = obs_trace.now()
      try:
        self._send(OP_LOOKUP, replica, b, real, padded)
        t1 = obs_trace.now()
        flat = host_flat(engine.apply_block(padded, b))
        parts = [torch.empty_like(flat) for _ in range(self.world)]
        t2 = obs_trace.now()
        torch_dist.gather(flat, parts, dst=0, group=self.pg)
        t3 = obs_trace.now()
      except Exception as e:
        self._abort(e)
        raise ReplicaLostError(
            f'serving batch {self.seq} (rung {b}) failed across the world '
            f'of {self.world}: {e!r}') from e
      finally:
        lookup_ms = (obs_trace.now() - t0) * 1000.0
        obs_trace.complete('serve/lookup', t0, lookup_ms / 1000.0, batch=b)
      self.batches += 1
      self.samples += real
      self.broadcast_ms += (t1 - t0) * 1000.0
      self.gather_ms += (t3 - t2) * 1000.0
    engine.count_lookup(b, real, lookup_ms)
    return self._assemble(parts, b)

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
    """Mark the link lost and destroy the leader's end of the control
    group (the caller holds the lock): its sockets close, so a follower
    waiting on it (a gather, the next broadcast) fails at once and ends
    its process instead of waiting out ``FOLLOWER_TIMEOUT_S``."""
    self.lost = e
    pg, self.pg = self.pg, None
    try:
      torch_dist.destroy_process_group(pg)
    except (RuntimeError, ValueError):
      # a group the fault already broke, or one destroyed before: the
      # batch's own error is the one raised
      pass

  def close(self):
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
      torch_dist.broadcast(self.buf, src=0, group=self.pg)
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
      torch_dist.gather(flat, None, dst=0, group=self.pg)
      self.batches += 1
      self.samples += real
      by_replica[replica] += 1
    self.closed = True
    return {'rank': self.rank, 'batches': self.batches,
            'samples': self.samples, 'by_replica': by_replica}


class RankFrontEnd:
  """The engine surface of a world of ranks on its leader; the batch loop
  on its followers (see the module docstring).

  Args:
    engine: this rank's ``ServingEngine`` over the whole initialised
      world (its mesh's product is the world, in rank order).
  """

  def __init__(self, engine, *, _link=None):
    mesh = engine.dist.mesh
    if not (torch_dist.is_available() and torch_dist.is_initialized()):
      raise ValueError('RankFrontEnd needs an initialised process group '
                       '(mesh.init_distributed)')
    if mesh.product_size < 2:
      raise ValueError('RankFrontEnd serves an engine of several ranks; '
                       'an engine of one rank needs none')
    if (mesh.product_size != torch_dist.get_world_size()
        or mesh.product_rank != torch_dist.get_rank()):
      raise not_ported(
          f'a serving front end over an engine on {mesh.product_size} of '
          f'the world\'s {torch_dist.get_world_size()} ranks (replicas on '
          'disjoint rank sets)', MULTI_RANK_ITEM)
    if _link is None:
      _link = _Link(engine)
    elif (engine.batch_size != _link.batch_size
          or tuple(engine.hotness) != _link.hotness
          or tuple(engine.output_dims) != _link.output_dims):
      raise ValueError(
          'a replica must match its link\'s batch, hotness and output '
          f'widths: batch {engine.batch_size} vs {_link.batch_size}, '
          f'hotness {tuple(engine.hotness)} vs {_link.hotness}')
    self._link = _link
    self.engine = engine
    self.replica_index = len(_link.engines)
    _link.engines.append(engine)

  def replica(self, engine) -> 'RankFrontEnd':
    """A front end for another engine over the same world (a replica of
    a pool), sharing this one's link; call it on every rank in one
    order."""
    return RankFrontEnd(engine, _link=self._link)

  # ------------------------------------------------------------ surface

  @property
  def link(self):
    """The world's link this front end shares with its replicas (a pool
    serves replicas of one link only)."""
    return self._link

  @property
  def rank(self) -> int:
    return self._link.rank

  @property
  def is_leader(self) -> bool:
    return self._link.rank == 0

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
    """The degraded mode's filter, on the leader before the broadcast
    (the broadcast carries the ids it kept)."""
    return self.engine.hot_only_filter(cats)

  @property
  def hot_filter_available(self) -> bool:
    return self.engine.hot_filter_available

  def _leader_only(self, what: str):
    if not self.is_leader:
      raise RuntimeError(
          f'{what} on follower rank {self.rank}: only the leader, '
          'product rank 0, admits requests; a follower runs '
          'serve_forever()')

  def lookup(self, cats, samples: Optional[int] = None
             ) -> List[torch.Tensor]:
    """``ServingEngine.lookup`` across the world: the per-input
    ``[rung, output_dim]`` answers of the WHOLE rung, f32 on the
    host."""
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
    """The engine's stats plus a ``front_end`` block: the world, the
    batches this link ran (every replica's), the broadcast and gather
    ms summed over them, and whether a rank was lost."""
    link = self._link
    with link.lock:
      block = {'world_size': link.world, 'replicas': len(link.engines),
               'batches': link.batches, 'samples': link.samples,
               'broadcast_ms': round(link.broadcast_ms, 3),
               'gather_ms': round(link.gather_ms, 3),
               'lost': link.lost is not None}
    return {**self.engine.stats(), 'front_end': block}

  # ---------------------------------------------------------- lifecycle

  def serve_forever(self) -> dict:
    """A follower's loop: run every batch the leader broadcasts until it
    closes; returns ``{'rank', 'batches', 'samples', 'by_replica'}``.  A fault is written to stderr and ends the process
    with ``FOLLOWER_FAULT_EXIT`` (the leader sees the rank go)."""
    if self.is_leader:
      raise RuntimeError('serve_forever runs on the follower ranks; the '
                         'leader admits requests')
    for e in self._link.engines:
      e.load_kernels()
    try:
      return self._link.serve()
    except Exception:
      print(f'serving front end: follower rank {self.rank} failed after '
            f'{self._link.batches} batch(es):', file=sys.stderr)
      traceback.print_exc()
      sys.stdout.flush()
      sys.stderr.flush()
      os._exit(FOLLOWER_FAULT_EXIT)

  def close(self):
    """The leader's shutdown: broadcast ``stop`` to every follower (none
    after a lost rank).  Idempotent; run it after closing the batcher
    or pool that uses this front end.  Closes every replica of the
    link."""
    self._leader_only('close')
    self._link.close()
