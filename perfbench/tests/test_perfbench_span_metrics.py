"""The readers of the metrics that read the program's spans,
``input_stall_pct`` and ``head_mfu_pct``, on a ``DeviceTrace`` built by
hand: one profiled step of 1000 us on the profiler's clock, its spans
and device operations placed where the readings can be worked out."""

import types

import pytest

from perfbench.core import registry
from perfbench.core.devtrace import DeviceTrace
from perfbench.counts import peaks

# the step annotation at 1000 us of the profiler's clock, the harness's
# clock reading 0 just before it: a span at perf_counter t us lies at
# t + 1000 on the profiler's clock
STEP = {'name': 'perfbench/step', 'cat': 'user_annotation', 'ph': 'X',
        'ts': 1000.0, 'dur': 1000.0}


def _op(corr, name, launch, start, end, cat='kernel'):
  """A device operation and the runtime call that launched it."""
  return [{'name': 'cudaLaunchKernel', 'cat': 'cuda_runtime', 'ph': 'X',
           'ts': launch, 'dur': 1.0, 'args': {'correlation': corr}},
          {'name': name, 'cat': cat, 'ph': 'X', 'ts': start,
           'dur': end - start, 'args': {'correlation': corr}}]


def _span(name, start, end):
  """A program span, profiler-clock ``start``..``end`` us."""
  return {'name': name, 'ts': start - 1000.0, 'dur': end - start}


def _trace(spans, ops):
  events = [STEP] + [e for op in ops for e in op]
  return DeviceTrace(events, spans, [0.0])


# fwd/inputs over 1000..1300: a pageable copy and a set alone
# (1000..1110), then idle, then a kernel (1200..1250) and the first 10 us
# of one that runs past the span's end (1290..1350), so 240 of its 300 us
# stall
INPUTS = [_span('fwd/inputs', 1000.0, 1300.0)]
INPUT_OPS = [_op(1, 'Memcpy HtoD (Pageable -> Device)', 1001.0, 1000.0,
                 1100.0, 'gpu_memcpy'),
             _op(2, 'Memset (Device)', 1101.0, 1100.0, 1110.0,
                 'gpu_memset'),
             _op(3, 'index_kernel', 1150.0, 1200.0, 1250.0),
             _op(4, 'cast_kernel', 1290.0, 1290.0, 1350.0)]
# the head: 100 us of kernels launched in each of its two spans, and a
# kernel launched outside them (the loss)
HEAD = [_span('head/forward', 1400.0, 1600.0),
        _span('head/backward', 1700.0, 1900.0)]
HEAD_OPS = [_op(5, 'gemm_fwd', 1450.0, 1450.0, 1550.0),
            _op(6, 'bce_kernel', 1650.0, 1650.0, 1690.0),
            _op(7, 'gemm_bwd', 1750.0, 1750.0, 1800.0),
            _op(8, 'gemm_bwd_w', 1760.0, 1800.0, 1850.0)]


def _ctx(trace, flops=None):
  """What a reader reads: the trace, two profiled batches, each step's
  ``flops`` at bf16."""
  return types.SimpleNamespace(
      trace=trace, profiled_batches=[0, 1],
      step_counts=lambda b: {'flops': flops, 'flop_dtype': 'bfloat16'})


def _read(name, ctx):
  return registry.metric_reader(name).read(ctx)


def test_input_stall_is_the_span_less_its_kernels():
  t = _trace(INPUTS + HEAD, INPUT_OPS + HEAD_OPS)
  assert t.window_us == 1000.0
  assert _read('input_stall_pct', _ctx(t)) == pytest.approx(24.0)


def test_input_stall_clips_a_span_to_the_window():
  # half of a 300 us span lies before the profiled window: the 150 us
  # inside it, none under a kernel
  t = _trace([_span('fwd/inputs', 850.0, 1150.0)], [])
  assert _read('input_stall_pct', _ctx(t)) == pytest.approx(15.0)


def test_input_stall_is_none_without_the_span():
  # the parent's program: no fwd/inputs span
  assert _read('input_stall_pct', _ctx(_trace(HEAD, HEAD_OPS))) is None
  assert _read('input_stall_pct', _ctx(None)) is None


def test_head_mfu_is_least_time_over_its_spans_device_time():
  t = _trace(INPUTS + HEAD, INPUT_OPS + HEAD_OPS)
  # 200 us of head kernels; each batch's least time 20 us at the bf16
  # peak, so 40 us of 200
  flops = 20e-6 * peaks.FLOP_PER_S['bfloat16']
  assert t.layer_device_s('head/forward') == pytest.approx(100e-6)
  assert t.layer_device_s('head/backward') == pytest.approx(100e-6)
  assert _read('head_mfu_pct', _ctx(t, flops)) == pytest.approx(20.0)


def test_head_mfu_is_none_without_device_time_in_its_spans():
  # the parent's program (no head spans), and head spans that launched
  # nothing
  assert _read('head_mfu_pct', _ctx(_trace(INPUTS, INPUT_OPS), 1.0)) is None
  t = _trace(HEAD, INPUT_OPS)
  assert _read('head_mfu_pct', _ctx(t, 1.0)) is None
  assert _read('head_mfu_pct', _ctx(None, 1.0)) is None
