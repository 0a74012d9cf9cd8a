"""The plain DLRM: bottom MLP over the numerical features, one row of
each table per sample, pairwise dot interaction with the bottom output
re-concatenated, top MLP to one logit (the reference's
``examples/dlrm/utils.py`` model), written from its description."""

from __future__ import annotations

import math

import torch

from perfbench.core import draw
from perfbench.reference import common


class Family(common.Family):

  def __init__(self, config: dict):
    super().__init__(config)
    self.tables = [(int(r), int(config['embedding_dim']))
                   for r in config['table_sizes']]
    self.input_table = list(range(len(self.tables)))

  def table_scale(self, t: int) -> float:
    return 1.0 / math.sqrt(self.tables[t][0])

  def _mlp_dims(self):
    c = self.config
    n = len(self.tables) + 1
    top_in = n * (n - 1) // 2 + c['embedding_dim']
    return [('bottom_mlp', c['num_numerical_features'],
             c['bottom_mlp_dims']),
            ('top_mlp', top_in, c['top_mlp_dims'])]

  def dense_leaves(self):
    out = []
    for m, (name, fan_in, dims) in enumerate(self._mlp_dims()):
      for i, d in enumerate(dims):
        out.append((f'{name}.layers.{i}.weight', (d, fan_in),
                    draw.mlp_stream(m, i, False), draw.glorot_scale(fan_in, d)))
        out.append((f'{name}.layers.{i}.bias', (d,),
                    draw.mlp_stream(m, i, True), draw.bias_scale(d)))
        fan_in = d
    return out

  def head(self, dense, numerical, emb_outs, num: common.Numerics):
    def mlp(name, x, n, last_linear):
      for i in range(n):
        x = num.linear(x, dense[f'{name}.layers.{i}.weight'],
                       dense[f'{name}.layers.{i}.bias'])
        if not (last_linear and i == n - 1):
          x = torch.relu(x)
      return x
    c = self.config
    x = mlp('bottom_mlp', num.act(numerical), len(c['bottom_mlp_dims']),
            False)
    feats = torch.stack([x] + [num.act(e) for e in emb_outs], dim=1)
    inter = num.bmm(feats, feats.transpose(1, 2))
    n = feats.shape[1]
    rows, cols = torch.tril_indices(n, n, offset=-1, device=feats.device)
    top_in = torch.cat([inter[:, rows, cols], x], dim=1)
    return mlp('top_mlp', top_in, len(c['top_mlp_dims']), True)


def optimizer(config: dict) -> common.Optimizer:
  """SGD at the reference DLRM schedule: linear warm-up, plateau,
  polynomial decay (computed in float64 here)."""
  o = config['optimizer']
  base, warm = float(o['learning_rate']), o['warmup_steps']
  start, decay, power = o['decay_start_step'], o['decay_steps'], o['poly_power']

  def lr(step):
    if step < warm:
      return base * (1.0 - (warm - step) / warm)
    if step < start:
      return base
    frac = min(max((start + decay - step) / decay, 0.0), 1.0)
    return base * frac ** power
  return common.Optimizer('sgd', lr)
