"""The plain reference's shared half: parameters regenerated from the
benchmark's draws at the rows a check needs, summed bags, the row-wise
and dense optimizers, and the training and scoring loops.

Plain PyTorch and NumPy: it imports neither JAX nor any module of the
program, and it takes nothing the program made.  It computes at the
configuration's precision: parameters kept at its storage dtype, the
head's activations and products at its compute dtype (f32 with TF32
off, or bf16 with f32 accumulation), the bags summed and the row-wise
updates computed in f32 and rounded once at the store, the MLPs'
optimizer in the parameters' own dtype (optax's rule).  ``precision``
selects the control: ``'int8'`` stores every table row and MLP row as
int8 with one f32 scale a row, ``'tf32'`` rounds both operands of
every product to TF32 first, the backward's too.
``fault`` plants a fault of the timed path for its reading:
``'half_batch'`` takes the loss's mean over the first half of each
batch only.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from perfbench.core import draw


@contextlib.contextmanager
def exact_matmul():
  """TF32 off for the reference's products, restored after."""
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def to_tf32(x: torch.Tensor) -> torch.Tensor:
  """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest even."""
  bits = x.contiguous().view(torch.int32)
  lsb = (bits >> 13) & 1
  bits = (bits + 0xFFF + lsb) & ~0x1FFF
  return bits.view(torch.float32)


def store(x: torch.Tensor, storage: str) -> torch.Tensor:
  """``x`` (f32, rows along the first axis) as the storage dtype keeps it,
  back in f32."""
  if storage == 'float32':
    return x
  if storage == 'bfloat16':
    return x.to(torch.bfloat16).float()
  if storage == 'int8':
    rows = x.reshape(x.shape[0], -1) if x.dim() > 1 else x.reshape(1, -1)
    scale = rows.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(rows / scale), -127, 127)
    return (q * scale).reshape(x.shape)
  raise ValueError(f'unknown storage {storage!r}')


class _TF32MatMul(torch.autograd.Function):
  """``a @ b`` with every product's operands rounded to TF32, the
  backward's products too (as TF32 tensor cores take them)."""

  @staticmethod
  def forward(ctx, a, b):
    ctx.save_for_backward(a, b)
    return to_tf32(a) @ to_tf32(b)

  @staticmethod
  def backward(ctx, g):
    a, b = ctx.saved_tensors
    g = to_tf32(g)
    return g @ to_tf32(b).transpose(-1, -2), to_tf32(a).transpose(-1, -2) @ g


class Numerics:
  """The storage and the products of one precision: ``'exact'`` (the
  configuration's), ``'int8'`` or ``'tf32'`` (the controls).

  ``store`` rounds a table's f32 values as its storage keeps them (back
  in f32); ``param`` is an MLP tensor as stored (bf16 storage: a bf16
  tensor); ``act`` casts an activation to the compute dtype."""

  def __init__(self, storage: str, compute: str, precision: str = 'exact'):
    self.precision = precision
    self.storage = 'int8' if precision == 'int8' else storage
    self.compute = getattr(torch, compute)

  def store(self, x):
    return store(x, self.storage)

  def param(self, x):
    if self.storage == 'bfloat16':
      return x.to(torch.bfloat16)
    return store(x.float(), self.storage)

  def act(self, x):
    return x.to(self.compute)

  def linear(self, x, w, b):
    if self.precision == 'tf32':
      return _TF32MatMul.apply(x, w.float().T) + b.float()
    return torch.nn.functional.linear(x, w.to(x.dtype), b.to(x.dtype))

  def bmm(self, a, b):
    if self.precision == 'tf32':
      return _TF32MatMul.apply(a, b)
    return torch.bmm(a, b)


def bce_mean(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
  x = logits.reshape(-1)
  y = labels.reshape(-1)
  return torch.mean(torch.clamp(x, min=0) - x * y +
                    torch.log1p(torch.exp(-torch.abs(x))))


class Rows:
  """One table's rows that a check touches: sorted ``ids``, their values
  ``[U, w]`` and optionally an accumulator, f32, all on one device."""

  def __init__(self, ids: torch.Tensor, values: torch.Tensor,
               acc: torch.Tensor = None):
    self.ids, self.values, self.acc = ids, values, acc

  def local(self, ids) -> torch.Tensor:
    """Positions in ``ids`` order of the ids ``ids`` (numpy or tensor)."""
    ids = torch.as_tensor(ids, device=self.ids.device).reshape(-1)
    return torch.searchsorted(self.ids, ids.to(torch.int64))


def touched(batches: List[dict], input_table: List[int], device
            ) -> Dict[int, torch.Tensor]:
  """``{table: sorted distinct ids}`` the batches look up (int64 on
  ``device``)."""
  out: Dict[int, list] = {}
  for b in batches:
    for i, t in enumerate(input_table):
      out.setdefault(t, []).append(torch.as_tensor(
          b['cats'][i], device=device).reshape(-1))
  return {t: torch.unique(torch.cat(v)).to(torch.int64)
          for t, v in out.items()}


class Family:
  """What a model family gives the loops (``reference/<family>.py``):
  its tables, inputs, dense leaves, head and optimizers."""

  def __init__(self, config: dict):
    self.config = config

  tables: List[tuple]          # [(rows, width)]
  input_table: List[int]

  def table_scale(self, t: int) -> float:
    raise NotImplementedError

  def dense_leaves(self) -> List[tuple]:
    """``[(name, shape, stream, scale)]`` in the program's key order."""
    raise NotImplementedError

  def head(self, dense, numerical, emb_outs, num: Numerics):
    raise NotImplementedError


def dense_init(family: Family, seed: int, num: Numerics, device
               ) -> Dict[str, torch.Tensor]:
  out = {}
  for name, shape, stream, scale in family.dense_leaves():
    n = shape[0] if len(shape) == 2 else 1
    w = shape[1] if len(shape) == 2 else shape[0]
    v = draw.uniform_rows(seed, stream, torch.arange(n, device=device), w,
                          scale)
    out[name] = num.param(v.reshape(shape))
  return out


def table_rows(family: Family, seed: int, ids_of: Dict[int, torch.Tensor],
               num: Numerics, device, acc: float = None
               ) -> Dict[int, Rows]:
  out = {}
  for t, ids in ids_of.items():
    w = family.tables[t][1]
    v = draw.uniform_rows(seed, t, ids, w, family.table_scale(t))
    a = (torch.full_like(v, acc) if acc is not None else None)
    out[t] = Rows(ids, num.store(v), a)
  return out


def embed(family: Family, rows: Dict[int, Rows], batch: dict, device
          ) -> List[torch.Tensor]:
  """Each input's summed bag ``[B, w]`` in f32, as leaves of autograd."""
  outs = []
  for i, t in enumerate(family.input_table):
    ids = batch['cats'][i]
    ids2 = ids.reshape(ids.shape[0], -1)
    pos = rows[t].local(ids2)
    bag = rows[t].values.index_select(0, pos).reshape(
        ids2.shape[0], ids2.shape[1], -1).sum(dim=1)
    outs.append(bag.detach().requires_grad_(True))
  return outs


def row_sums(family: Family, rows: Dict[int, Rows], batch: dict,
             cotangents: List[torch.Tensor], device
             ) -> Dict[int, torch.Tensor]:
  """``{table: [U, w]}`` each row's summed gradient: every id of a bag
  takes the bag's cotangent."""
  sums = {t: torch.zeros_like(r.values) for t, r in rows.items()}
  for i, t in enumerate(family.input_table):
    ids = batch['cats'][i]
    h = 1 if ids.ndim == 1 else ids.shape[1]
    pos = rows[t].local(ids)
    g = cotangents[i].float()
    if h > 1:
      g = g.repeat_interleave(h, dim=0)
    sums[t].index_add_(0, pos, g)
  return sums


class Optimizer:
  """The configuration's optimizers with the program's semantics:
  ``'sgd'`` (row-wise on the tables, optax-style on the MLPs) on a
  ``step -> lr`` schedule, or ``'adagrad'`` (row-wise dedup on the
  tables: ``a += S * S; t -= lr * S * rsqrt(a + eps)``; optax's on the
  MLPs: ``a += g * g; u = -lr * g * rsqrt(a + eps)`` where ``a > 0``)."""

  def __init__(self, kind: str, lr, initial: float = 0.0, eps: float = 0.0):
    self.kind, self.lr, self.initial, self.eps = kind, lr, initial, eps

  def rate(self, step: int) -> float:
    return float(self.lr(step)) if callable(self.lr) else float(self.lr)

  def tables(self, rows: Dict[int, Rows], sums, step: int, num: Numerics):
    lr = self.rate(step)
    for t, r in rows.items():
      s = sums[t]
      if self.kind == 'sgd':
        r.values = num.store(r.values - lr * s)
      else:
        r.acc = r.acc + s * s
        r.values = num.store(r.values - lr * s * torch.rsqrt(r.acc + self.eps))

  def dense(self, params: Dict[str, torch.Tensor], grads, acc, step: int,
            num: Numerics):
    lr = self.rate(step)
    for k, p in params.items():
      g = grads[k]
      if self.kind == 'sgd':
        # optax: the update in the gradient's dtype at -lr rounded to it,
        # added in the parameter's dtype
        scale = float(torch.tensor(-lr, dtype=g.dtype))
        params[k] = num.param(p + (g * scale).to(p.dtype))
      else:
        acc[k] = acc[k] + g * g
        inv = torch.where(acc[k] > 0, torch.rsqrt(acc[k] + self.eps),
                          torch.zeros_like(acc[k]))
        params[k] = num.param(p - lr * g * inv)


def train(family: Family, opt: Optimizer, seed: int, batches: List[dict],
          start_step: int, device, precision: str = 'exact',
          fault: str = None) -> dict:
  """Three (``len(batches)``) training steps from the drawn state:
  ``{'losses', 'rows1', 'rows', 'init', 'after1', 'after'}`` where
  ``rows1`` are the first batch's touched ids, ``rows`` the union over
  the batches (sorted ids on ``device``), and each state is ``{'tables',
  'acc', 'dense', 'dense_acc'}`` of f32 tensors at those rows (``init``:
  the drawn state at ``rows``)."""
  num = Numerics(family.config['param_dtype'],
                 family.config['compute_dtype'], precision)
  rows1 = touched(batches[:1], family.input_table, device)
  rows_of = touched(batches, family.input_table, device)
  adagrad = opt.kind == 'adagrad'
  with exact_matmul():
    tables = table_rows(family, seed, rows_of, num, device,
                        acc=opt.initial if adagrad else None)
    dense = dense_init(family, seed, num, device)
    dense_acc = ({k: torch.full_like(v, opt.initial, dtype=torch.float32)
                  for k, v in dense.items()} if adagrad else None)
    init = snapshot(tables, dense, dense_acc, rows_of)
    losses, after1 = [], None
    for k, batch in enumerate(batches):
      step = start_step + k
      emb = embed(family, tables, batch, device)
      leaves = {n: v.detach().requires_grad_(True) for n, v in dense.items()}
      numerical = torch.as_tensor(batch['numerical'], device=device)
      labels = torch.as_tensor(batch['labels'], device=device)
      logits = family.head(leaves, numerical, emb, num).float()
      if fault == 'half_batch':
        half = logits.shape[0] // 2
        loss = bce_mean(logits[:half], labels[:half])
      else:
        loss = bce_mean(logits, labels)
      loss.backward()
      losses.append(float(loss.detach()))
      sums = row_sums(family, tables, batch, [e.grad for e in emb], device)
      opt.tables(tables, sums, step, num)
      grads = {n: v.grad for n, v in leaves.items()}
      with torch.no_grad():
        opt.dense(dense, grads, dense_acc, step, num)
      if k == 0:
        after1 = snapshot(tables, dense, dense_acc, rows1)
    after = snapshot(tables, dense, dense_acc, rows_of)
  return {'losses': losses, 'rows1': rows1, 'rows': rows_of, 'init': init,
          'after1': after1, 'after': after}


def snapshot(tables: Dict[int, Rows], dense, dense_acc, rows_of) -> dict:
  """The state at ``rows_of`` (f32 tensors on the reference's device)."""
  def at(r: Rows, ids, x):
    return x.index_select(0, r.local(ids))
  return {
      'tables': {t: at(tables[t], ids, tables[t].values)
                 for t, ids in rows_of.items()},
      'acc': ({t: at(tables[t], ids, tables[t].acc)
               for t, ids in rows_of.items()}
              if next(iter(tables.values())).acc is not None else None),
      'dense': {k: v.detach().float().clone() for k, v in dense.items()},
      'dense_acc': ({k: v.float().clone() for k, v in dense_acc.items()}
                    if dense_acc is not None else None)}


def score(family: Family, seed: int, batches: List[dict], device,
          precision: str = 'exact') -> List[np.ndarray]:
  """The sigmoid predictions of each batch, f32 numpy ``[B]``."""
  num = Numerics(family.config['param_dtype'],
                 family.config['compute_dtype'], precision)
  out = []
  with exact_matmul(), torch.no_grad():
    dense = dense_init(family, seed, num, device)
    for batch in batches:
      rows = table_rows(family, seed,
                        touched([batch], family.input_table, device), num,
                        device)
      emb = [e.detach() for e in embed(family, rows, batch, device)]
      numerical = torch.as_tensor(batch['numerical'], device=device)
      logits = family.head(dense, numerical, emb, num)
      out.append(torch.sigmoid(logits.float()).reshape(-1).cpu().numpy())
  return out
