"""FLOPs of the DLRM head (MLPs and dot interaction) and the bytes of
its embedding layers, from the configuration's shapes and the batch."""

from __future__ import annotations

from perfbench.counts import embedding


def _sizes(dtype: str) -> int:
  return {'float32': 4, 'bfloat16': 2, 'float16': 2}[dtype]


def head_flops(config: dict, batch_size: int, train: bool) -> int:
  """Forward: 2 B in out a layer, 2 B n n d for the interaction's
  products.  Training adds the weight gradients (2 B in out a layer),
  the input gradients of every layer but the bottom MLP's first (its
  input is not trained), and the interaction's two backward products."""
  c = config
  n = len(c['table_sizes']) + 1
  d = c['embedding_dim']
  layers = []
  fan_in = c['num_numerical_features']
  for k, out in enumerate(c['bottom_mlp_dims']):
    layers.append((fan_in, out, k > 0))
    fan_in = out
  fan_in = n * (n - 1) // 2 + d
  for out in c['top_mlp_dims']:
    layers.append((fan_in, out, True))
    fan_in = out
  fwd = sum(2 * batch_size * i * o for i, o, _ in layers)
  inter = 2 * batch_size * n * n * d
  if not train:
    return fwd + inter
  bwd = sum(2 * batch_size * i * o * (2 if needs_dx else 1)
            for i, o, needs_dx in layers)
  return fwd + bwd + 3 * inter


def tables(config: dict):
  return [(r, config['embedding_dim']) for r in config['table_sizes']]


def input_table(config: dict):
  return list(range(len(config['table_sizes'])))


def step_counts(config: dict, batch: dict, train: bool) -> dict:
  """``{'flops', 'flop_dtype', 'lookup_bytes', 'apply_bytes'}`` of one
  step on ``batch``."""
  tb = _sizes(config['param_dtype'])
  cb = _sizes(config['compute_dtype'])
  b = batch['numerical'].shape[0]
  out = {'flops': head_flops(config, b, train),
         'flop_dtype': config['compute_dtype'],
         'lookup_bytes': embedding.lookup_bytes(
             batch, tables(config), input_table(config), tb, cb)}
  if train:
    out['apply_bytes'] = embedding.apply_bytes(
        batch, tables(config), input_table(config), tb, cb, 0)
  return out
