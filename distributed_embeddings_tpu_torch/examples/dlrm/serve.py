"""Serve a trained DLRM checkpoint: export, engine, dynamic batcher.  The
port's counterpart of ``examples/dlrm/serve.py`` (docs/design.md §14).

Point it at a training checkpoint written by ``main.py --save_state``
(or a ``--resume_dir`` checkpoint directory): it freezes the newest
valid file into a read-only serving bundle (optimizer members stripped,
quantized tables kept narrow), restores the bundle into a
``ServingEngine`` on ``--device`` and drives a simulated concurrent
request stream through the ``DynamicBatcher``, printing p50 / p99
latency, QPS and batch fill for the three arms (no batching, the
monolithic batcher, the rung ladder with the pipelined dispatch),
the padding the ladder saved, where the traffic landed on the ladder
and the pipeline's overlap.  ``--overload_qps`` adds the overload arm: a
``ServingEnginePool`` of ``--replicas`` engines offered more than it
serves, replica 0 quarantined half-way (the failover drill).

    python -m distributed_embeddings_tpu_torch.examples.dlrm.main \\
        --save_state build/dlrm_state.npz ...
    python -m distributed_embeddings_tpu_torch.examples.dlrm.serve \\
        --checkpoint build/dlrm_state.npz --batch 1024 --requests 512 \\
        --hot_coverage 0.98 --serve_buckets 128,256,512,1024

The JAX example's flags and prints, plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions).  One difference:
the bundle embeds the tables' configs (the DLRM's tables are
combiner-free, so the export passes ``combiner=None``), so the engine
starts from the bundle alone, without model code.  ``--trace PATH``
arms the observability layer and writes the Chrome trace of the request
path (submit, enqueue, dispatch, lookup, execute, demux spans) to PATH
when the run ends, then resets the layer; ``python -m
distributed_embeddings_tpu_torch.tools.trace_report PATH`` reads it.
``main`` returns the printed JSON block.

Across ranks (no JAX counterpart flag: JAX's single controller serves
all of a host's devices at once): given a world, torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``env://``) or ``--init_method``,
``--world_size`` and ``--rank``, every rank joins it
(``mesh.init_distributed``; ``--dist_backend`` defaults to NCCL on
cuda, and gloo puts several ranks on one card), the leader exports the
bundle and every rank loads it (one host, or a shared file system), the
batch is cut to a multiple of the world as JAX's ``serve.py`` cuts it to
its devices, and every rank builds its engines (and the overload arm's
replicas) behind one ``serving.RankFrontEnd``.  The leader runs the arms
and prints and returns the JSON block; every other rank runs
``serve_forever``, prints one count line and returns its counts.
``--trace`` traces the leader.

    torchrun --nproc_per_node 4 -m \
        distributed_embeddings_tpu_torch.examples.dlrm.serve \
        --checkpoint build/dlrm_state.npz --batch 1024
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from typing import Optional

import numpy as np

import torch.distributed as torch_dist

from distributed_embeddings_tpu_torch import obs, serving
from distributed_embeddings_tpu_torch.models.synthetic import (
    gen_power_law_data)
from distributed_embeddings_tpu_torch.obs import trace as obs_trace
from distributed_embeddings_tpu_torch.parallel import hotcache
from distributed_embeddings_tpu_torch.parallel import mesh as mesh_lib


def build_parser() -> argparse.ArgumentParser:
  """The JAX example's flags, plus ``--device`` and the world's."""
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--checkpoint', required=True,
                      help='save_train_npz file or checkpoint directory '
                      '(newest valid file wins)')
  parser.add_argument('--bundle', default=None,
                      help='where to write the serving bundle '
                      '(default: a temp file, deleted after the run)')
  parser.add_argument('--embedding_dim', type=int, default=128)
  parser.add_argument('--batch', type=int, default=1024,
                      help='the LARGEST serving batch (the top ladder '
                      'rung)')
  parser.add_argument('--serve_buckets', default=None,
                      help='comma-separated ladder rungs, e.g. '
                      '"128,256,512,1024"; default: the pow-2 ladder '
                      '{B/8, B/4, B/2, B}.  The full batch alone is the '
                      'monolithic single-rung engine.')
  parser.add_argument('--requests', type=int, default=512,
                      help='simulated request count')
  parser.add_argument('--request_sizes', default='1,2,4,8',
                      help='request sample counts (cycled)')
  parser.add_argument('--max_delay_ms', type=float, default=2.0,
                      help='batcher admission deadline')
  parser.add_argument('--concurrency', type=int, default=8,
                      help='closed-loop in-flight requests')
  parser.add_argument('--alpha', type=float, default=1.05,
                      help='power-law exponent of the simulated ids')
  parser.add_argument('--hot_coverage', type=float, default=0.98,
                      help='serving hot-cache coverage target '
                      '(0 disables the cache)')
  parser.add_argument('--hot_budget_mb', type=float, default=512.0)
  parser.add_argument('--overload_qps', type=float, default=None,
                      help='arm the overload A/B: offer this open-loop '
                      'rate to a ServingEnginePool (0 = one unpaced '
                      'burst) and print the healthy, shedding and '
                      'degraded rows.  Default: off')
  parser.add_argument('--priority_mix', type=float, default=0.5,
                      help='high-priority fraction of the overload '
                      'traffic (error-diffusion interleave)')
  parser.add_argument('--replicas', type=int, default=2,
                      help='replica engines behind the overload pool; '
                      '>1 quarantines replica 0 mid-burst (failover '
                      'drill)')
  parser.add_argument('--deadline_ms', type=float, default=50.0,
                      help='per-request deadline in the overload arm')
  parser.add_argument('--trace', default=None, metavar='PATH',
                      help='arm the observability layer (obs/) and '
                      'write the Chrome-trace JSON of the request path '
                      '(submit -> enqueue -> dispatch -> lookup -> demux '
                      'spans) to PATH: open it in Perfetto or read it '
                      'with python -m distributed_embeddings_tpu_torch.'
                      'tools.trace_report')
  parser.add_argument('--device', default='cuda',
                      help="the serving device ('cuda' or 'cpu'); with a "
                      "world, 'cuda' is card rank %% device count")
  env_world = 'WORLD_SIZE' in os.environ
  parser.add_argument('--init_method',
                      default='env://' if env_world else None,
                      help='the world\'s rendezvous (tcp://host:port, '
                      'file://path; default env:// under torchrun)')
  parser.add_argument('--world_size', type=int,
                      default=int(os.environ.get('WORLD_SIZE', 1)),
                      help='ranks serving together (default torchrun\'s '
                      'WORLD_SIZE, else 1: no world)')
  parser.add_argument('--rank', type=int,
                      default=int(os.environ.get('RANK', 0)),
                      help='this process\'s rank; 0 leads')
  parser.add_argument('--dist_backend', default=None,
                      help='the engine\'s collectives: nccl (default on '
                      'cuda), gloo (several ranks on one card; the '
                      'default on the CPU)')
  return parser


def _join_world(args, parser) -> Optional[mesh_lib.Mesh]:
  """The world given by the flags or torchrun's environment, joined;
  None without one."""
  if args.world_size <= 1:
    return None
  if not args.init_method:
    parser.error(f'--world_size {args.world_size} needs --init_method '
                 '(or torchrun\'s environment)')
  return mesh_lib.init_distributed(
      args.init_method, args.world_size, args.rank,
      backend=args.dist_backend,
      device=None if args.device == 'cuda' else args.device)


def main(argv=None) -> dict:
  parser = build_parser()
  args = parser.parse_args(argv)
  mesh = _join_world(args, parser)
  leader = mesh is None or args.rank == 0
  if args.trace and leader:
    obs.enable(trace_path=args.trace)

  bundle = args.bundle
  tmp = None
  if bundle is None and leader:
    tmp = tempfile.NamedTemporaryFile(suffix='.npz', delete=False)
    bundle = tmp.name
    tmp.close()
  front = None
  try:
    if leader:
      # DLRM tables are hotness-1 combiner-free lookups (main.py's
      # TableConfig default); the shapes come from the verified
      # checkpoint
      summary = serving.export_bundle_from_checkpoint(
          args.checkpoint, bundle, combiner=None)
    if mesh is not None:
      # every rank reads the file the leader wrote
      box = [bundle]
      torch_dist.broadcast_object_list(box, src=0)
      bundle = box[0]
    weights, meta = serving.load_serving_bundle(bundle)
    configs = meta['table_configs']
    if leader:
      print(f"bundle: {summary['tables']} table(s) from "
            f"{os.path.basename(summary['source'])} step "
            f"{summary['step']} [{','.join(summary['quantized']) or 'f32'}"
            f"; {summary['stripped_state_leaves']} optimizer slot(s) "
            'stripped]', flush=True)

    hot_sets = None
    if args.hot_coverage > 0 and args.alpha > 0:
      hot_sets = hotcache.analytic_power_law_hot_sets(
          configs, args.alpha, coverage=args.hot_coverage,
          budget_bytes=int(args.hot_budget_mb * 2**20), state_copies=0)
    # one process, one device; or every rank of the world
    n_dev = 1 if mesh is None else mesh.product_size
    batch = max(n_dev, (args.batch // n_dev) * n_dev)
    buckets = None
    if args.serve_buckets:
      buckets = [int(b) for b in str(args.serve_buckets).split(',')
                 if b.strip()]

    def new_engine():
      return serving.ServingEngine(configs, weights, batch_size=batch,
                                   buckets=buckets, hot_sets=hot_sets,
                                   device=args.device, mesh=mesh,
                                   bundle_meta=meta)

    replicas = max(1, int(args.replicas))
    engine = new_engine()
    pool_engines = None
    if mesh is not None:
      # every rank builds the same engines behind one front end, in one
      # order; the followers then run the leader's batches
      engine = front = serving.RankFrontEnd(engine)
      if args.overload_qps is not None:
        pool_engines = [front] + [front.replica(new_engine())
                                  for _ in range(replicas - 1)]
      if not leader:
        counts = front.serve_forever()
        print(f"rank {counts['rank']}: served {counts['batches']} "
              f"batch(es), {counts['samples']} samples, for the leader "
              f"(by replica {counts['by_replica']})", flush=True)
        return counts
    print(f'engine: batch {batch} on {n_dev} device(s), ladder '
          f'{list(engine.buckets)}, '
          f"table_dtype {engine.stats()['table_dtype']}, hot rows "
          f'{sum(h.size for h in (hot_sets or {}).values())}', flush=True)

    # simulated power-law request traffic: the synthetic generators' own
    # id law (gen_power_law_data, the one shared definition)
    rng = np.random.default_rng(0)
    pool = []
    for c in configs:
      if args.alpha > 0:
        ids = gen_power_law_data(rng, args.requests * 8, 1,
                                 c.input_dim, args.alpha).reshape(-1)
        pool.append(np.clip(ids, 0, c.input_dim - 1).astype(np.int32))
      else:
        pool.append(rng.integers(0, c.input_dim,
                                 size=(args.requests * 8,)).astype(
                                     np.int32))
    sizes = [int(s) for s in args.request_sizes.split(',')]
    requests = serving.split_requests(pool, sizes=sizes,
                                      limit=args.requests)
    stats = serving.measure_serving(engine, requests,
                                    max_delay_ms=args.max_delay_ms,
                                    concurrency=args.concurrency)
    if hot_sets:
      stats['serve_hot_hit_rate'] = serving.hot_hit_rate(
          hot_sets, configs, list(range(len(configs))), requests)
    # the three arms: what batching bought, what the ladder saved, what
    # the pipeline hid
    print('A/B  no-batch   : '
          f"p50 {stats['serve_nobatch_p50_ms']} ms  "
          f"p99 {stats['serve_nobatch_p99_ms']} ms  "
          f"qps {stats['serve_nobatch_qps']}  "
          f"pad {stats['serve_nobatch_pad_waste_pct']}%")
    print('A/B  monolithic : '
          f"p50 {stats['serve_mono_p50_ms']} ms  "
          f"p99 {stats['serve_mono_p99_ms']} ms  "
          f"qps {stats['serve_mono_qps']}  "
          f"pad {stats['serve_mono_pad_waste_pct']}%  "
          f"fill {stats['serve_mono_batch_fill']}")
    print('A/B  ladder+pipe: '
          f"p50 {stats['serve_p50_ms']} ms  "
          f"p99 {stats['serve_p99_ms']} ms  "
          f"qps {stats['serve_qps']}  "
          f"pad {stats['serve_pad_waste_pct']}%  "
          f"fill {stats['serve_batch_fill']}")
    print(f"bucket ladder {stats['serve_buckets']}: launches "
          f"{stats['serve_bucket_launches']} "
          f"({stats['serve_pad_rows']} of "
          f"{stats['serve_rows_launched']} launched rows were padding)")
    print('pipeline overlap '
          f"{stats['serve_pipeline_overlap_pct']} "
          f"(merge+demux {stats['serve_pipeline_merge_demux_ms']} ms, "
          f"consumer blocked {stats['serve_pipeline_blocked_ms']} ms)",
          flush=True)
    if args.overload_qps is not None:
      # the same weights behind a replica pool, offered more than it can
      # serve: healthy is the closed-loop headline above; shedding and
      # degraded are what the overload layer did about the difference
      if pool_engines is None:
        pool_engines = [engine] + [new_engine()
                                   for _ in range(replicas - 1)]
      over = serving.measure_overload(
          pool_engines, requests, max_delay_ms=args.max_delay_ms,
          deadline_ms=args.deadline_ms, priority_mix=args.priority_mix,
          offered_qps=args.overload_qps or None,
          failover_after=(len(requests) // 2 if replicas > 1 else None))
      stats.update(over)
      print('A/B  healthy    : '
            f"p50 {stats['serve_p50_ms']} ms  "
            f"p99 {stats['serve_p99_ms']} ms  "
            f"p99.9 {stats['serve_p999_ms']} ms  "
            f"qps {stats['serve_qps']} (closed-loop, no sheds)")
      print('A/B  shedding   : high '
            f"p50 {over['serve_over_high_p50_ms']} ms  "
            f"p99 {over['serve_over_high_p99_ms']} ms  "
            f"p99.9 {over['serve_over_high_p999_ms']} ms  "
            f"shed {over['serve_over_high_shed']} | low "
            f"p50 {over['serve_over_low_p50_ms']} ms  "
            f"p99 {over['serve_over_low_p99_ms']} ms  "
            f"shed {over['serve_over_low_shed']} "
            f"(offered {over['serve_over_offered_qps']} qps, served "
            f"{over['serve_over_qps']} qps, shed rate "
            f"{over['serve_over_shed_rate']}; by reason: deadline "
            f"{over['serve_over_shed_deadline']}, queue_full "
            f"{over['serve_over_shed_queue_full']})")
      print('A/B  degraded   : '
            f"{over['serve_over_degraded_served']} low-priority "
            'request(s) served hot-cache-only across '
            f"{over['serve_over_degraded_enters']} enter(s) / "
            f"{over['serve_over_degraded_exits']} exit(s); failover: "
            f"{over['serve_over_quarantined']} replica(s) quarantined, "
            f"{over['serve_over_failovers']} request retry(ies), "
            'zero accepted requests lost')
    print(json.dumps(stats), flush=True)
    return stats
  finally:
    if front is not None and leader:
      front.close()
    if tmp is not None and os.path.exists(bundle):
      os.remove(bundle)
    if mesh is not None:
      torch_dist.destroy_process_group()
    if args.trace and leader:
      path = obs_trace.save()
      print(f'obs trace: {obs_trace.event_count()} event(s) -> {path} '
            '(open in Perfetto, or: python -m '
            f'distributed_embeddings_tpu_torch.tools.trace_report {path})',
            flush=True)
      obs.reset()


if __name__ == '__main__':
  main()
