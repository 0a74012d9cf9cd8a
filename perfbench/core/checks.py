"""The numbers that decide ``correct``, each held against its limit.

Training (three checked steps from the drawn state, the program's and
the reference's readings of the same batches):

- ``loss_gap``: the largest of the three steps' ``|L - L_ref| / |L_ref|``
  (of the first ``loss_steps``, where the cell's file gives it: a model
  whose loss swings by a factor of ten from step to step amplifies
  round-off in its third loss and in nothing else that is compared).
- ``grad_norm_gap``: the first step's gradient as the optimizer got it,
  worked out from the state after one step (SGD: ``(t0 - t1) / lr`` at
  the rows the step touched; Adagrad: ``sqrt(a1 - a0)`` from the
  accumulator), its norm per leaf (each table, each MLP tensor); the
  worst leaf's ``|n - n_ref|`` over the larger of that leaf's and the
  median leaf's reference norm.
- ``change_norm_gap``: the same for the norm of the change ``t3 - t0``
  after the three steps, leaving out the leaves whose reference first
  gradient is under a thousandth of the median leaf's (their change is
  round-off).

Scoring: ``pred_gap``, the largest ``|p - p_ref|`` over every
prediction the window returned.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

EXCLUDE_BELOW = 1e-3


def _norm(x: torch.Tensor) -> float:
  return float(torch.linalg.vector_norm(x.double()))


def first_grad_norms(side: dict, init: dict, rows: dict, rows1: dict,
                     kind: str, lr: float, initial: float, device
                     ) -> Dict[str, float]:
  """Per leaf, the norm of the first step's gradient from ``side``'s
  state after one step (``side['after1']``) and the drawn ``init``."""
  a1 = side['after1']
  on = lambda x: x.to(device, torch.float32)
  out = {}
  for t, ids in rows1.items():
    if kind == 'sgd':
      t0 = init['tables'][t].index_select(0, torch.searchsorted(rows[t],
                                                                ids))
      out[f'table_{t}'] = _norm(on(t0) - on(a1['tables'][t])) / lr
    else:
      out[f'table_{t}'] = math.sqrt(float(torch.clamp(
          on(a1['acc'][t]).double() - initial, min=0).sum()))
  for k, v in a1['dense'].items():
    if kind == 'sgd':
      out[k] = _norm(on(init['dense'][k]) - on(v)) / lr
    else:
      out[k] = math.sqrt(float(torch.clamp(
          on(a1['dense_acc'][k]).double() - initial, min=0).sum()))
  return out


def change_norms(side: dict, init: dict, device) -> Dict[str, float]:
  """Per leaf, the norm of the change after the checked steps."""
  a = side['after']
  on = lambda x: x.to(device, torch.float32)
  out = {f'table_{t}': _norm(on(v) - on(init['tables'][t]))
         for t, v in a['tables'].items()}
  out.update({k: _norm(on(v) - on(init['dense'][k]))
              for k, v in a['dense'].items()})
  return out


def _median(values) -> float:
  v = sorted(values)
  n = len(v)
  return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def worst_gap(got: Dict[str, float], want: Dict[str, float],
              leaves=None):
  """``(gap, leaf)``: the largest ``|got - want|`` over ``max(want_leaf,
  median want)`` among ``leaves`` (default: all)."""
  leaves = list(want) if leaves is None else list(leaves)
  med = _median(want.values())
  gap, worst = 0.0, None
  for k in leaves:
    g = abs(got.get(k, float('nan')) - want[k]) / max(want[k], med, 1e-30)
    if not g <= gap:  # NaN wins
      gap, worst = g, k
  return gap, worst


def train_numbers(prog: dict, ref: dict, kind: str, lr: float,
                  initial: float, device='cpu',
                  loss_steps: Optional[int] = None) -> Dict[str, tuple]:
  """``{name: (value, detail)}`` of a side against the reference: both
  are ``reference.common.train``-shaped (the program's ``init``,
  ``rows`` and ``rows1`` are the reference's)."""
  init, rows, rows1 = ref['init'], ref['rows'], ref['rows1']
  n = len(ref['losses']) if loss_steps is None else int(loss_steps)
  loss = max((abs(p - r) / max(abs(r), 1e-30)
              if math.isfinite(p) else float('inf'))
             for p, r in zip(prog['losses'][:n], ref['losses'][:n]))
  g_ref = first_grad_norms(ref, init, rows, rows1, kind, lr, initial, device)
  g_got = first_grad_norms(prog, init, rows, rows1, kind, lr, initial, device)
  g_gap, g_leaf = worst_gap(g_got, g_ref)
  med = _median(g_ref.values())
  moving = [k for k, v in g_ref.items() if v >= EXCLUDE_BELOW * med]
  c_gap, c_leaf = worst_gap(change_norms(prog, init, device),
                            change_norms(ref, init, device), moving)
  return {'loss_gap': (loss, f'steps 1-{n}'),
          'grad_norm_gap': (g_gap, g_leaf),
          'change_norm_gap': (c_gap, c_leaf)}


def judge(numbers: Dict[str, tuple], limits: Dict[str, float]) -> dict:
  """``{name: {'value', 'limit', 'at'}}`` and whether every number is
  finite and within its limit."""
  out, ok = {}, True
  for name, limit in limits.items():
    value, detail = numbers.get(name, (float('nan'), 'not read'))
    out[name] = {'value': value, 'limit': limit, 'at': detail}
    ok = ok and math.isfinite(value) and value <= limit
  return {'checks': out, 'correct': ok}
