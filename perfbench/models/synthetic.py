"""The synthetic family through the port: ``models.synthetic.
SyntheticModel`` with the sparse hybrid step on ``SparseAdagrad`` and
the dense ``adagrad`` (the JAX package's bench settings, as
``chip_smoke.py``'s ``build_trainer`` builds them)."""

from __future__ import annotations

import torch

from perfbench.models import _port


class Program:
  """One synthetic model on the card, its tables and MLP drawn from
  ``seed``; ``step(fed)`` runs one sparse hybrid step and returns the
  loss (a 0-d tensor on the card)."""

  def __init__(self, config: dict, device: str, seed: int, kind: str,
               start_step: int = 0):
    from distributed_embeddings_tpu_torch import optim
    from distributed_embeddings_tpu_torch.models import dlrm, synthetic
    from distributed_embeddings_tpu_torch.parallel import sparse
    if kind != 'train':
      raise ValueError('the synthetic family trains only')
    cfg = synthetic.ModelConfig(
        config['name'],
        tuple(synthetic.EmbeddingConfig(b['num_tables'], tuple(b['nnz']),
                                        b['num_rows'], b['width'],
                                        b['shared'])
              for b in config['embedding_configs']),
        tuple(config['mlp_sizes']), config['num_numerical_features'],
        config['interact_stride'])
    model = synthetic.SyntheticModel(
        cfg, dp_input=config['dp_input'], strategy=config['dist_strategy'],
        param_dtype=getattr(torch, config['param_dtype']),
        compute_dtype=getattr(torch, config['compute_dtype']),
        device=device)
    dist = model.dist_embedding
    scale = float(config['table_init_scale'])
    model.embedding_params = _port.fill_tables(dist, seed, lambda t: scale)
    _port.fill_mlp_(model.mlp, seed, 0)
    opt = config['optimizer']
    if (opt['tables'], opt['dense']) != ('SparseAdagrad', 'adagrad'):
      raise ValueError('the synthetic family runs Adagrad only')
    dense_opt = optim.adagrad(opt['learning_rate'],
                              initial_accumulator_value=opt[
                                  'initial_accumulator_value'],
                              eps=opt['epsilon'])
    emb_opt = sparse.SparseAdagrad(
        learning_rate=opt['learning_rate'],
        initial_accumulator_value=opt['initial_accumulator_value'],
        epsilon=opt['epsilon'])

    def head_loss(dense_params, emb_outs, batch):
      numerical, labels = batch
      return dlrm.bce_with_logits(model.head(numerical, emb_outs,
                                             dense_params), labels)

    self._step = sparse.make_hybrid_train_step(dist, head_loss, dense_opt,
                                               emb_opt)
    state = sparse.init_hybrid_train_state(
        dist, {'embedding': model.embedding_params, **model.dense_params()},
        dense_opt, emb_opt)
    self.state = state._replace(step=start_step)
    self.kind, self.model, self.dist = kind, model, dist
    self.order = _port.worker_order(dist)
    self.dense_names = list(model.dense_params())

  def feed(self, batch: dict):
    return ([batch['cats'][i] for i in self.order],
            (batch['numerical'], batch['labels']))

  def step(self, fed) -> torch.Tensor:
    cats, dense = fed
    self.state, loss = self._step(self.state, list(cats), dense)
    return loss

  def read_state(self, rows_of: dict) -> dict:
    """The tables and Adagrad accumulators at rows ``rows_of[table]``, the
    dense params and their sums of squares, f32 on the host."""
    params = self.state.params
    dense_state, emb_state = self.state.opt_state
    acc = {k: v['acc'] for k, v in emb_state.items()}
    sos = dense_state['sum_of_squares']
    return {'tables': _port.read_tables(self.dist, params['embedding'],
                                        rows_of),
            'acc': _port.read_tables(self.dist, acc, rows_of),
            'dense': {k: _port.host(params[k])
                      for k in self.dense_names},
            'dense_acc': {k: _port.host(sos[k])
                          for k in self.dense_names}}

  def instrument(self, spans: list):
    """Record the lookup layer's calls as spans (``_port``)."""
    _port.instrument_lookup(self.dist, spans)

  def release(self):
    self.state = self._step = self.model = self.dist = None
