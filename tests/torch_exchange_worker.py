"""One rank of the port's multi-rank forward, for
tests/test_torch_exchange.py: joins a gloo world on the CPU, runs
``DistributedEmbedding.apply`` on its slice of the batch and saves what
it got.  Imports nothing of JAX (spawned processes import only this)."""

import json
import pickle


def run(rank, world_size, init_method, case_path, out_dir):
  import numpy as np
  import torch
  import torch.distributed as torch_dist

  from distributed_embeddings_tpu_torch.parallel import checkpoint
  from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib
  from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
      DistributedEmbedding)
  from distributed_embeddings_tpu_torch.parallel.planner import TableConfig

  torch.set_num_threads(1)
  with open(case_path, 'rb') as f:
    case = pickle.load(f)
  m = mesh_lib.init_distributed(init_method, world_size, rank,
                                backend='gloo', device='cpu')
  try:
    tables = [TableConfig(r, w, combiner=c) for r, w, c in case['tables']]
    dist = DistributedEmbedding(tables, mesh=m, **case['options'])
    params = checkpoint.set_weights(dist, case['weights'])
    b = case['batch'] // world_size
    mine = [c[rank * b:(rank + 1) * b] for c in case['cats']]
    outs = dist.apply(params, mine)
    back = checkpoint.get_weights(dist, params)
    legs = [l.as_dict() for l in dist.lookup_plan().legs]
    np.savez(f'{out_dir}/rank{rank}.npz',
             *[o.numpy() for o in outs])
    np.savez(f'{out_dir}/weights{rank}.npz', *[w.numpy() for w in back])
    with open(f'{out_dir}/legs{rank}.json', 'w') as f:
      json.dump(legs, f)
    # no rank tears gloo down while the other still talks to it
    torch_dist.barrier()
  finally:
    torch_dist.destroy_process_group()
