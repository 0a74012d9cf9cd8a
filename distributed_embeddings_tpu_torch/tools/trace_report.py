"""Stall-attribution report over an obs trace file: the port's own copy
of ``tools/trace_report.py`` (the same flags, output, exit codes and
JSON), reading the port's span names and categories.

Reads a Chrome-trace-event JSON written by
``distributed_embeddings_tpu_torch.obs.trace.save()`` (or the JAX
package's) and prints:

- the per-phase totals table (count / total / mean ms and the span's
  category: host work, wait = blocked time, device = the devprof lane;
  the JAX package's trace-time step phases are 'trace');
- the per-step breakdown: for every ``train/step`` span, the phases and
  blocked time that landed inside its window, beside the step's wall;
- the critical path: how much of the observed wall had host work, a
  wait or a device-lane phase in flight (interval unions), and how much
  no span covers (device execution and untraced host code).

Exits 2 on a malformed or truncated trace, 3 on unregistered span names
under ``--strict``, 4 on required spans missing under ``--require``:

    python -m distributed_embeddings_tpu_torch.tools.trace_report trace.json
    python -m distributed_embeddings_tpu_torch.tools.trace_report \\
        trace.json --strict --require train/step,fwd/exchange --json
"""

from __future__ import annotations

import argparse
import json
import sys

from typing import Any, Callable, Dict, List, Optional

from distributed_embeddings_tpu_torch.obs.trace import (REGISTERED_SPANS,
                                                         span_category)

# the exit-code contract of the repository's tools
EXIT_OK, EXIT_MALFORMED, EXIT_STRICT, EXIT_REQUIRE = 0, 2, 3, 4
_CODES = {'MALFORMED': EXIT_MALFORMED, 'STRICT': EXIT_STRICT,
          'REQUIRE': EXIT_REQUIRE}


def _fail(klass: str, message: Any) -> int:
  """The uniform ``trace_report: KLASS: message`` stderr line; returns
  the class's exit code."""
  print(f'trace_report: {klass}: {message}', file=sys.stderr)
  return _CODES[klass]


def _emit(payload: Any, as_json: bool, text: Callable[[], str]) -> None:
  """The JSON payload (``--json``) or the text rendering."""
  if as_json:
    print(json.dumps(payload, indent=2, default=str))
  else:
    out = text()
    if out:
      print(out)


_KNOWN_PH = {'X', 'B', 'E', 'b', 'e', 'i', 'M'}


class TraceFormatError(ValueError):
  """The file is not a well-formed obs trace (malformed JSON, missing
  traceEvents, or an event violating the schema)."""


def load_trace(path: str) -> List[Dict[str, Any]]:
  """Parse + schema-validate one trace file; returns the event list.
  Raises ``TraceFormatError`` on anything a truncated write, a partial
  copy, or a hand-edited file can produce."""
  try:
    with open(path, 'r', encoding='utf-8') as f:
      payload = json.load(f)
  except OSError as e:
    raise TraceFormatError(f'{path}: unreadable: {e}') from e
  except json.JSONDecodeError as e:
    raise TraceFormatError(
        f'{path}: malformed/truncated JSON: {e}') from e
  if isinstance(payload, list):  # bare-array form is legal Chrome trace
    events = payload
  elif isinstance(payload, dict):
    events = payload.get('traceEvents')
    if not isinstance(events, list):
      raise TraceFormatError(
          f'{path}: no traceEvents list (not a trace file)')
  else:
    raise TraceFormatError(f'{path}: not a trace object or array')
  open_async: Dict[Any, int] = {}
  for k, ev in enumerate(events):
    if not isinstance(ev, dict):
      raise TraceFormatError(f'{path}: event {k} is not an object')
    name = ev.get('name')
    ph = ev.get('ph')
    if not isinstance(name, str) or not name:
      raise TraceFormatError(f'{path}: event {k} has no name')
    if ph not in _KNOWN_PH:
      raise TraceFormatError(
          f'{path}: event {k} ({name!r}) has unknown ph {ph!r}')
    if ph == 'M':
      continue
    if not isinstance(ev.get('ts'), (int, float)):
      raise TraceFormatError(
          f'{path}: event {k} ({name!r}) has no numeric ts')
    if ph == 'X':
      dur = ev.get('dur')
      if not isinstance(dur, (int, float)) or dur < 0:
        raise TraceFormatError(
            f'{path}: X event {k} ({name!r}) needs dur >= 0, got {dur!r}')
    if ph in ('b', 'e'):
      key = (ev.get('cat'), name, ev.get('id'))
      if ev.get('id') is None:
        raise TraceFormatError(
            f'{path}: async event {k} ({name!r}) has no id')
      if ph == 'b':
        open_async[key] = open_async.get(key, 0) + 1
      else:
        if open_async.get(key, 0) <= 0:
          raise TraceFormatError(
              f"{path}: async end without begin for {name!r} "
              f"id={ev.get('id')!r}")
        open_async[key] -= 1
  dangling = {k for k, v in open_async.items() if v}
  if dangling:
    raise TraceFormatError(
        f'{path}: {len(dangling)} async span(s) never closed '
        f'(truncated trace?): {sorted(dangling)[:3]}')
  return events


def _durations(events) -> List[Dict[str, Any]]:
  """X events plus b/e pairs folded into {name, cat, ts, dur} rows
  (microseconds)."""
  rows = []
  open_async: Dict[Any, List[float]] = {}
  for ev in events:
    ph = ev.get('ph')
    if ph == 'X':
      rows.append({'name': ev['name'],
                   'cat': ev.get('cat') or span_category(ev['name']),
                   'ts': float(ev['ts']), 'dur': float(ev['dur']),
                   'args': ev.get('args') or {}})
    elif ph == 'b':
      open_async.setdefault(
          (ev.get('cat'), ev['name'], ev.get('id')), []).append(
              float(ev['ts']))
    elif ph == 'e':
      starts = open_async.get((ev.get('cat'), ev['name'], ev.get('id')))
      if starts:
        t0 = starts.pop()
        rows.append({'name': ev['name'],
                     'cat': ev.get('cat') or span_category(ev['name']),
                     'ts': t0, 'dur': float(ev['ts']) - t0, 'args': {}})
  return rows


def union_ms(rows) -> float:
  """The wall (ms) at least one of ``rows`` (``_durations`` rows, us)
  covers: nested and overlapping spans count once."""
  ivs = sorted((r['ts'], r['ts'] + r['dur']) for r in rows)
  total, cur_lo, cur_hi = 0.0, None, None
  for lo, hi in ivs:
    if cur_hi is None or lo > cur_hi:
      if cur_hi is not None:
        total += cur_hi - cur_lo
      cur_lo, cur_hi = lo, hi
    else:
      cur_hi = max(cur_hi, hi)
  if cur_hi is not None:
    total += cur_hi - cur_lo
  return total / 1000.0


def report(events) -> Dict[str, Any]:
  """The analysis dict ``format_report`` renders (and ``--json``
  emits)."""
  rows = _durations(events)
  phases: Dict[str, Dict[str, Any]] = {}
  for r in rows:
    p = phases.setdefault(r['name'], {'count': 0, 'total_ms': 0.0,
                                      'cat': r['cat']})
    p['count'] += 1
    p['total_ms'] += r['dur'] / 1000.0
  for p in phases.values():
    p['total_ms'] = round(p['total_ms'], 3)
    p['mean_ms'] = round(p['total_ms'] / p['count'], 3)

  # per-step attribution: host phases and blocked time inside each
  # train/step window (event midpoint decides membership — phases on
  # other threads legitimately straddle the boundaries)
  steps = []
  step_rows = sorted((r for r in rows if r['name'] == 'train/step'),
                     key=lambda r: r['ts'])
  others = [r for r in rows if r['name'] != 'train/step']
  for sr in step_rows:
    lo, hi = sr['ts'], sr['ts'] + sr['dur']
    inside = [r for r in others
              if lo <= r['ts'] + r['dur'] / 2.0 < hi]
    entry = {
        'step': sr['args'].get('step'),
        'wall_ms': round(sr['dur'] / 1000.0, 3),
        'phases': {},
    }
    for r in inside:
      d = entry['phases'].setdefault(r['name'], 0.0)
      entry['phases'][r['name']] = d + r['dur'] / 1000.0
    entry['phases'] = {k: round(v, 3)
                       for k, v in sorted(entry['phases'].items())}
    entry['blocked_ms'] = round(
        sum(v for k, v in entry['phases'].items()
            if span_category(k) == 'wait'), 3)
    steps.append(entry)

  # critical path over interval UNIONS, not duration sums: spans nest
  # (serve/dispatch ⊇ serve/execute ⊇ serve/lookup) and concurrent
  # requests' waits overlap, so summing durations double-counts and
  # clamps the unattributed remainder to a misleading 0 — union time
  # answers "how much wall had host work / a wait in flight"
  span0 = min((r['ts'] for r in rows), default=0.0)
  span1 = max((r['ts'] + r['dur'] for r in rows), default=0.0)
  wall_ms = (span1 - span0) / 1000.0
  attributed = union_ms([r for r in rows if r['cat'] in ('host', 'wait')])
  # the devprof device lane (design §19): measured per-phase device
  # time splits the old unattributed remainder into device-attributed
  # wall vs the residue no span covers
  device_ms = union_ms([r for r in rows if r['cat'] == 'device'])
  covered = union_ms([r for r in rows
                      if r['cat'] in ('host', 'wait', 'device')])
  return {
      'events': len(rows),
      'wall_ms': round(wall_ms, 3),
      'phases': {k: phases[k] for k in sorted(phases)},
      'unregistered': sorted(
          n for n in phases if n not in REGISTERED_SPANS),
      'steps': steps,
      'critical_path': {
          'host_ms': round(
              union_ms([r for r in rows if r['cat'] == 'host']), 3),
          'blocked_ms': round(
              union_ms([r for r in rows if r['cat'] == 'wait']), 3),
          'trace_time_ms': round(
              union_ms([r for r in rows if r['cat'] == 'trace']), 3),
          # wall not covered by any host/wait span: device execution
          # and untraced host code — the honest remainder, never
          # claimed as attributed
          'unattributed_ms': round(max(0.0, wall_ms - attributed), 3),
          # the remainder's split (design §19): wall the device lane
          # attributes, and the residue no span of any category covers
          'device_ms': round(device_ms, 3),
          'residue_ms': round(max(0.0, wall_ms - covered), 3),
      },
  }


def format_report(rep: Dict[str, Any]) -> str:
  out = []
  out.append(f"trace: {rep['events']} span(s) over "
             f"{rep['wall_ms']:.1f} ms wall")
  out.append('')
  out.append(f"{'phase':<22} {'cat':<6} {'count':>6} "
             f"{'total_ms':>10} {'mean_ms':>9}")
  for name, p in rep['phases'].items():
    out.append(f"{name:<22} {p['cat']:<6} {p['count']:>6} "
               f"{p['total_ms']:>10.3f} {p['mean_ms']:>9.3f}")
  cp = rep['critical_path']
  out.append('')
  out.append('critical path: '
             f"host {cp['host_ms']:.1f} ms, "
             f"blocked {cp['blocked_ms']:.1f} ms, "
             f"trace-time {cp['trace_time_ms']:.1f} ms, "
             f"unattributed (device + untraced host) "
             f"{cp['unattributed_ms']:.1f} ms")
  if cp.get('device_ms'):
    out.append('device lane: '
               f"{cp['device_ms']:.1f} ms device-attributed "
               '(obs.devprof segmented dispatch), residue '
               f"{cp['residue_ms']:.1f} ms uncovered by any span")
  if rep['steps']:
    out.append('')
    out.append('per-step breakdown:')
    for s in rep['steps']:
      parts = ' '.join(f'{k}={v:.2f}' for k, v in s['phases'].items())
      out.append(f"  step {s['step']}: wall {s['wall_ms']:.2f} ms, "
                 f"blocked {s['blocked_ms']:.2f} ms"
                 + (f' | {parts}' if parts else ''))
  if rep['unregistered']:
    out.append('')
    out.append('WARNING: unregistered span name(s): '
               + ', '.join(rep['unregistered'])
               + ' (not in obs.REGISTERED_SPANS - typo, or a span '
               'added without registering it)')
  return '\n'.join(out)


def main(argv: Optional[List[str]] = None) -> int:
  ap = argparse.ArgumentParser(
      prog='trace_report',
      description='Per-step phase breakdown + stall attribution over an '
      'obs Chrome-trace file; nonzero exit on a malformed trace '
      '(pipeline-gate friendly).',
      formatter_class=argparse.RawDescriptionHelpFormatter)
  ap.add_argument('--json', action='store_true',
                  help='emit the result as JSON instead of text')
  ap.add_argument('--strict', action='store_true',
                  help='exit 3 when any span name is not in '
                  'obs.REGISTERED_SPANS')
  ap.add_argument('trace', help='trace JSON written by obs.trace.save()')
  ap.add_argument('--require', default=None,
                  help='comma-separated span names that must appear; '
                  'exit 4 otherwise')
  args = ap.parse_args(argv)
  try:
    events = load_trace(args.trace)
  except TraceFormatError as e:
    return _fail('MALFORMED', e)
  rep = report(events)
  _emit(rep, args.json, lambda: format_report(rep))
  if args.strict and rep['unregistered']:
    return _fail('STRICT',
                 f"unregistered span name(s) {rep['unregistered']}")
  if args.require:
    missing = [n for n in args.require.split(',')
               if n and n not in rep['phases']]
    if missing:
      return _fail('REQUIRE', f'missing span(s) {missing}')
  return EXIT_OK


if __name__ == '__main__':
  sys.exit(main())
