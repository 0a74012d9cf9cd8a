"""The dlrm family through the port: ``models.dlrm.DLRM`` with the
sparse hybrid step that ``examples/dlrm/main.py``'s ``make_trainer(...,
'sparse', ...)`` builds, or its forward for scoring as ``run_eval``
calls it."""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.models import _port


class Program:
  """One DLRM on the card, its tables and MLPs drawn from ``seed``.

  ``kind`` ``'train'``: ``step(fed)`` runs one sparse hybrid step and
  returns the loss (a 0-d tensor on the card); the optimizers' step
  counts start at ``start_step``.  ``'eval'``: ``predict(fed)`` returns
  the sigmoid predictions on the host."""

  def __init__(self, config: dict, device: str, seed: int, kind: str,
               start_step: int = 0):
    from distributed_embeddings_tpu_torch.models.dlrm import DLRM
    self.kind = kind
    dtype = getattr(torch, config['param_dtype'])
    model = DLRM(table_sizes=config['table_sizes'],
                 embedding_dim=config['embedding_dim'],
                 bottom_mlp_dims=config['bottom_mlp_dims'],
                 top_mlp_dims=config['top_mlp_dims'],
                 num_numerical_features=config['num_numerical_features'],
                 dist_strategy=config['dist_strategy'],
                 dp_input=config['dp_input'], param_dtype=dtype,
                 compute_dtype=getattr(torch, config['compute_dtype']),
                 device=device)
    dist = model.dist_embedding
    sizes = config['table_sizes']
    model.embedding_params = _port.fill_tables(
        dist, seed, lambda t: 1.0 / math.sqrt(sizes[t]))
    _port.fill_mlp_(model.bottom_mlp, seed, 0)
    _port.fill_mlp_(model.top_mlp, seed, 1)
    self.model, self.dist = model, dist
    self.order = _port.worker_order(dist)
    self.dense_names = list(model.dense_params())
    if kind == 'train':
      from distributed_embeddings_tpu_torch.examples.dlrm import main
      opt = config['optimizer']
      if (opt['tables'], opt['dense'], opt['warmup_steps'],
          opt['decay_start_step'], opt['decay_steps'],
          opt['poly_power']) != ('SparseSGD', 'sgd', 8000, 48000, 24000, 2):
        raise ValueError('make_trainer runs SparseSGD and SGD on the '
                         'reference schedule only')
      self._step, state = main.make_trainer(model, 'sparse',
                                            opt['learning_rate'])
      # resumed at ``start_step``: the step count the tables' schedule
      # reads and the dense optimizer's own count
      state.opt_state[0]['count'] = start_step
      self.state = state._replace(step=start_step)

  def feed(self, batch: dict):
    """A pool batch as the program takes it: worker-order ids on the
    host, as a data loader yields them."""
    return (batch['numerical'], [batch['cats'][i] for i in self.order],
            batch['labels'])

  def step(self, fed) -> torch.Tensor:
    numerical, cats, labels = fed
    self.state, loss = self._step(self.state, numerical, list(cats), labels)
    return loss

  def predict(self, fed) -> np.ndarray:
    numerical, cats, _ = fed
    params = {'embedding': self.model.embedding_params,
              **self.model.dense_params()}
    with torch.no_grad():
      preds = torch.sigmoid(self.model.apply(params, numerical, list(cats)))
    return preds.float().cpu().numpy().reshape(-1)

  def read_state(self, rows_of: dict) -> dict:
    """The state at rows ``rows_of[table]`` and the dense params, f32 on
    the host."""
    params = (self.state.params if self.kind == 'train' else
              {'embedding': self.model.embedding_params,
               **self.model.dense_params()})
    return {'tables': _port.read_tables(self.dist, params['embedding'],
                                        rows_of),
            'acc': None,
            'dense': {k: _port.host(params[k])
                      for k in self.dense_names},
            'dense_acc': None}

  def instrument(self, spans: list):
    """Record the lookup layer's calls as spans (``_port``)."""
    _port.instrument_lookup(self.dist, spans)

  def release(self):
    self.state = self._step = self.model = self.dist = None
