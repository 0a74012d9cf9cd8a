"""The plain synthetic model: each input's summed bag, concatenated in
input order (average-pooled with the configuration's stride, if any),
the numerical features appended, an MLP to one logit (the reference's
``synthetic_models`` model), written from its description."""

from __future__ import annotations

import torch

from perfbench.core import draw
from perfbench.reference import common
from perfbench.traffic import power_law


class Family(common.Family):

  def __init__(self, config: dict):
    super().__init__(config)
    self.tables, self.input_table, _ = power_law.expand(config)

  def table_scale(self, t: int) -> float:
    return float(self.config['table_init_scale'])

  def dense_leaves(self):
    c = self.config
    fan_in = sum(self.tables[t][1] for t in self.input_table)
    if c['interact_stride']:
      fan_in = -(-fan_in // c['interact_stride'])
    fan_in += c['num_numerical_features']
    out = []
    for i, d in enumerate(list(c['mlp_sizes']) + [1]):
      out.append((f'mlp.layers.{i}.weight', (d, fan_in),
                  draw.mlp_stream(0, i, False), draw.glorot_scale(fan_in, d)))
      out.append((f'mlp.layers.{i}.bias', (d,), draw.mlp_stream(0, i, True),
                  draw.bias_scale(d)))
      fan_in = d
    return out

  def head(self, dense, numerical, emb_outs, num: common.Numerics):
    x = torch.cat([num.act(e) for e in emb_outs], dim=1)
    stride = self.config['interact_stride']
    if stride:
      b, f = x.shape
      pad = -(-f // stride) * stride - f
      sums = torch.nn.functional.pad(x, (0, pad)).reshape(b, -1, stride).sum(-1)
      counts = torch.nn.functional.pad(torch.ones(f, device=x.device),
                                       (0, pad)).reshape(-1, stride).sum(-1)
      x = sums / counts
    x = torch.cat([x, num.act(numerical)], dim=1)
    n = len(self.config['mlp_sizes']) + 1
    for i in range(n):
      x = num.linear(x, dense[f'mlp.layers.{i}.weight'],
                     dense[f'mlp.layers.{i}.bias'])
      if i < n - 1:
        x = torch.relu(x)
    return x


def optimizer(config: dict) -> common.Optimizer:
  o = config['optimizer']
  return common.Optimizer('adagrad', float(o['learning_rate']),
                          float(o['initial_accumulator_value']),
                          float(o['epsilon']))
