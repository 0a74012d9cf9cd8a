"""FLOPs of the synthetic models' MLP head and the bytes of their
embedding layers, from the configuration's shapes and the batch."""

from __future__ import annotations

from perfbench.counts import embedding
from perfbench.traffic import power_law


def _sizes(dtype: str) -> int:
  return {'float32': 4, 'bfloat16': 2, 'float16': 2}[dtype]


def head_flops(config: dict, batch_size: int, train: bool) -> int:
  """2 B in out a layer forward; training adds the weight and input
  gradients of every layer (the first layer's input gradient is the
  embeddings' cotangent)."""
  tables, input_table, _ = power_law.expand(config)
  fan_in = sum(tables[t][1] for t in input_table)
  if config['interact_stride']:
    fan_in = -(-fan_in // config['interact_stride'])
  fan_in += config['num_numerical_features']
  total = 0
  for out in list(config['mlp_sizes']) + [1]:
    total += 2 * batch_size * fan_in * out * (3 if train else 1)
    fan_in = out
  return total


def step_counts(config: dict, batch: dict, train: bool) -> dict:
  tables, input_table, _ = power_law.expand(config)
  tb = _sizes(config['param_dtype'])
  cb = _sizes(config['compute_dtype'])
  b = batch['numerical'].shape[0]
  out = {'flops': head_flops(config, b, train),
         'flop_dtype': config['compute_dtype'],
         'lookup_bytes': embedding.lookup_bytes(batch, tables, input_table,
                                                tb, cb)}
  if train:
    # Adagrad: one f32 accumulator row beside each table row
    out['apply_bytes'] = embedding.apply_bytes(batch, tables, input_table,
                                               tb, cb, 4)
  return out
