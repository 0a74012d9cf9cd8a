"""The profiled part of a traced run, read from ``torch.profiler``'s
trace.

The harness profiles a few steps (CPU and CUDA activities) with the
program's span tracer armed, each step inside a ``perfbench/step``
annotation.  From the exported trace it takes the device operations
(kernels, copies, sets) with their correlation ids, and the host-side
launch records that carry the same ids.  The program's spans
(``obs/trace.py``: ``fwd/lookup_combine``, ``apply/update``, ...) are
on ``time.perf_counter``; the annotations tie that clock to the
profiler's (the median offset between each annotation's start and the
harness's own clock reading just before it).  A device operation
belongs to the innermost program span open when its launch was issued.

Nothing here falls back to a host number: a trace with no device time
gives no device metric.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import tempfile
import time
from typing import List, Optional

import numpy as np

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
STEP_ANNOTATION = 'perfbench/step'


def _merge(intervals):
  """Union of ``[(start, end)]`` as sorted disjoint intervals."""
  out = []
  for s, e in sorted(intervals):
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return out


class DeviceTrace:
  """The profiled steps: ``window_us``, ``busy_us``, device time by
  program span, the device operations by name and the idle gaps by what
  the host was doing."""

  def __init__(self, events: List[dict], spans: List[dict],
               step_starts_s: List[float]):
    ann = sorted((e for e in events if e.get('name') == STEP_ANNOTATION
                  and e.get('cat') == 'user_annotation'),
                 key=lambda e: e['ts'])
    if len(ann) != len(step_starts_s) or not ann:
      raise ValueError(f'{len(ann)} step annotations for '
                       f'{len(step_starts_s)} profiled steps')
    # perf_counter (us) + offset = profiler clock (us)
    self.offset_us = statistics.median(
        a['ts'] - s * 1e6 for a, s in zip(ann, step_starts_s))
    self.t0 = ann[0]['ts']
    self.t1 = max(a['ts'] + a['dur'] for a in ann)
    self.steps = len(ann)
    dev = [e for e in events if e.get('cat') in DEVICE_CATS
           and e.get('ph') == 'X']
    launch_ts = {e['args']['correlation']: e['ts'] for e in events
                 if e.get('cat') in LAUNCH_CATS and 'args' in e
                 and 'correlation' in e['args']}
    # the program's spans on the profiler clock, innermost first
    self.spans = sorted(
        ((s['ts'] + self.offset_us, s['ts'] + s['dur'] + self.offset_us,
          s['name']) for s in spans), key=lambda s: s[1] - s[0])
    self.ops = []  # (name, start, end, layer)
    for e in dev:
      s, d = e['ts'], e.get('dur', 0.0)
      if s + d < self.t0 or s > self.t1:
        continue
      corr = e.get('args', {}).get('correlation')
      lt = launch_ts.get(corr)
      layer = self._span_at(lt) if lt is not None else None
      self.ops.append((e['name'], max(s, self.t0), min(s + d, self.t1),
                       layer))
    self.window_us = self.t1 - self.t0
    busy = _merge((s, e) for _, s, e, _ in self.ops)
    self.busy_us = sum(e - s for s, e in busy)
    self.gaps = []
    prev = self.t0
    for s, e in busy + [[self.t1, self.t1]]:
      if s > prev:
        self.gaps.append((prev, s))
      prev = max(prev, e)
    cpu = [e for e in events if e.get('cat') == 'cpu_op'
           and e.get('ph') == 'X']
    self._cpu_s = np.array([e['ts'] for e in cpu], dtype=np.float64)
    self._cpu_e = np.array([e['ts'] + e['dur'] for e in cpu],
                           dtype=np.float64)
    self._cpu_n = [e['name'] for e in cpu]

  def _span_at(self, ts: float) -> Optional[str]:
    for s, e, name in self.spans:
      if s <= ts <= e:
        return name
    return None

  def _host_at(self, ts: float) -> str:
    span = self._span_at(ts) or 'outside the program spans'
    if self._cpu_s.size:
      inside = np.nonzero((self._cpu_s <= ts) & (self._cpu_e >= ts))[0]
      if inside.size:
        k = inside[np.argmin(self._cpu_e[inside] - self._cpu_s[inside])]
        return f'{span}: {self._cpu_n[k]}'
    return f'{span}: python'

  def layer_device_s(self, layer: str) -> float:
    """Seconds of device operations launched inside span ``layer``."""
    return sum(e - s for _, s, e, lay in self.ops if lay == layer) / 1e6

  def breakdown(self, n: int = 10) -> dict:
    by_name = collections.Counter()
    for name, s, e, _ in self.ops:
      by_name[name] += (e - s) / 1e6
    by_host = collections.Counter()
    for s, e in self.gaps:
      by_host[self._host_at((s + e) / 2)] += (e - s) / 1e6
    return {'device_ops': [[k[:200], v] for k, v in by_name.most_common(n)],
            'idle_gaps': [[k[:200], v] for k, v in by_host.most_common(n)]}


def profile_steps(run_step, n_steps: int, span_tracer,
                  own_spans: List[tuple]) -> DeviceTrace:
  """Run ``run_step(k)`` for ``k < n_steps`` under the profiler with the
  program's span tracer armed; the parsed trace.  ``own_spans`` collects
  the harness's own ``(name, start_s, end_s)`` spans around calls into
  layers the program spans not (perf_counter seconds).  The exported
  file goes to the run's temporary directory and is deleted."""
  import torch
  from torch.profiler import ProfilerActivity, profile, record_function
  span_tracer.clear()
  span_tracer.enable()
  # anchor: an event at a known perf_counter reading gives the tracer's
  # own origin (its events are microseconds from it)
  anchor = time.perf_counter()
  span_tracer.complete('perfbench/anchor', anchor, 0.0)
  starts = []
  del own_spans[:]
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for k in range(n_steps):
      starts.append(time.perf_counter())
      with record_function(STEP_ANNOTATION):
        run_step(k)
    torch.cuda.synchronize()
  span_tracer.disable()
  events = span_tracer.events()
  span_tracer.clear()
  origin_us = next(anchor * 1e6 - e['ts'] for e in events
                   if e.get('name') == 'perfbench/anchor')
  # every span on perf_counter microseconds
  spans = [dict(e, ts=e['ts'] + origin_us) for e in events
           if e.get('ph') == 'X' and e.get('name') != 'perfbench/anchor']
  spans += [{'name': n, 'ts': s * 1e6, 'dur': (e - s) * 1e6}
            for n, s, e in own_spans]
  fd, path = tempfile.mkstemp(suffix='.json')
  os.close(fd)
  try:
    prof.export_chrome_trace(path)
    with open(path, encoding='utf-8') as f:
      trace = json.load(f)
  finally:
    os.unlink(path)
  return DeviceTrace(trace['traceEvents'], spans, starts)
