"""The harness, driven on the CPU at a tiny size with the look for a
card skipped: a sound run comes out correct, and each fault the timed
path can have on one card makes ``correct`` false.  (A cell on one card
has no exchange between cards to leave out.)  The control, the reference
one precision below the configuration's in the program's place, fails
the cell's limits too."""

import time

import pytest
import torch

from perfbench import calibrate
from perfbench.core import bench
from perfbench.tests import tiny

TRAIN_CELLS = ('dlrm-mlperf.train-sgd', 'small-v3.train-adagrad')


def run(tmp_path, name, hook=None, seed=7):
  return bench.run_cell(tiny.cell(tmp_path, name), seed, 0.5, False,
                        time.perf_counter(), device='cpu',
                        program_hook=hook)


@pytest.mark.parametrize('name', TRAIN_CELLS + ('dlrm-mlperf.eval',))
def test_sound_run_is_correct(tmp_path, name):
  out = run(tmp_path, name)
  assert out['correct'], out['checks']
  assert list(out)[-1] == 'checks'


def _unchanged(prog):
  """Every step returns the state it was given: the step runs, and its
  writes are undone."""
  inner = prog._step

  def step(state, *args):
    tensors = [t for t in _leaves(state) if isinstance(t, torch.Tensor)]
    saved = [t.detach().clone() for t in tensors]
    new, loss = inner(state, *args)
    with torch.no_grad():
      for t, s in zip(tensors, saved):
        t.copy_(s)
    return state, loss
  prog._step = step


def _leaves(tree):
  if isinstance(tree, dict):
    return [x for v in tree.values() for x in _leaves(v)]
  if isinstance(tree, (list, tuple)):
    return [x for v in tree for x in _leaves(v)]
  return [tree]


def _half_batch(prog):
  """The step sees half of each batch: the mean is taken over the rest."""
  feed = prog.feed

  def half(batch):
    n = batch['labels'].shape[0] // 2
    return feed({'numerical': batch['numerical'][:n],
                 'cats': [c[:n] for c in batch['cats']],
                 'labels': batch['labels'][:n]})
  prog.feed = half


def _altered_answer(prog):
  """One prediction altered where it is produced."""
  predict = prog.predict

  def altered(fed):
    p = predict(fed)
    p[17] = 1.0 - p[17]
    return p
  prog.predict = altered


@pytest.mark.parametrize('name', TRAIN_CELLS)
@pytest.mark.parametrize('fault', [_unchanged, _half_batch])
def test_training_fault_is_not_correct(tmp_path, name, fault):
  out = run(tmp_path, name, fault)
  assert not out['correct'], out['checks']


@pytest.mark.parametrize('fault', [_altered_answer, _half_batch])
def test_scoring_fault_is_not_correct(tmp_path, fault):
  out = run(tmp_path, 'dlrm-mlperf.eval', fault)
  assert not out['correct'], out['checks']


@pytest.mark.parametrize('name', TRAIN_CELLS + ('dlrm-mlperf.eval',))
def test_control_is_not_correct(tmp_path, name):
  cell = tiny.cell(tmp_path, name)
  sides = dict(calibrate.readings(cell, 5, True, device='cpu'))
  limits = cell.cell['checks']
  for side in ('program', 'control'):
    ok = all(sides[side][n][0] <= limits[n] for n in limits)
    assert ok == (side == 'program'), (side, sides[side], limits)


@pytest.mark.parametrize('name,steps', [('small-v3.train-adagrad', 2),
                                        ('dlrm-mlperf.train-sgd', 3)])
def test_loss_gap_covers_the_cell_files_steps(tmp_path, name, steps):
  """A cell file's ``loss_steps`` sets how many of the checked steps'
  losses are compared; without it all three are."""
  out = run(tmp_path, name)
  assert out['checks']['loss_gap']['at'] == f'steps 1-{steps}'
