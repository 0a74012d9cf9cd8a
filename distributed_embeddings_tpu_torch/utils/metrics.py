"""Evaluation metrics: the port's copy of
``distributed_embeddings_tpu/utils/metrics.py`` (numpy only).

The reference evaluates DLRM with ``tf.keras.metrics.AUC(num_thresholds=
8000, curve='ROC', summation_method='interpolation')``: the same
threshold-bucketed streaming AUC, plus the exact rank-statistic AUC as
its oracle.
"""

from __future__ import annotations

import numpy as np


class StreamingAUC:
  """Threshold-bucketed ROC AUC with trapezoidal interpolation.

  The Keras construction: ``num_thresholds`` evenly spaced thresholds in
  (0, 1) (plus -eps / 1 + eps endpoints), confusion counts accumulated
  per threshold, area by trapezoid over (FPR, TPR).
  """

  def __init__(self, num_thresholds: int = 8000):
    if num_thresholds < 2:
      raise ValueError('num_thresholds must be >= 2')
    eps = 1e-7
    inner = (np.arange(1, num_thresholds - 1, dtype=np.float64)
             / (num_thresholds - 1))
    self.thresholds = np.concatenate([[-eps], inner, [1.0 + eps]])
    self.reset()

  def reset(self):
    self.true_positives = np.zeros_like(self.thresholds)
    self.false_positives = np.zeros_like(self.thresholds)
    self.pos_count = 0.0
    self.neg_count = 0.0

  def update(self, labels, predictions):
    """Accumulate a batch: ``labels`` in {0,1}, ``predictions`` in [0,1]."""
    labels = np.asarray(labels, np.float64).reshape(-1)
    predictions = np.asarray(predictions, np.float64).reshape(-1)
    if labels.shape != predictions.shape:
      raise ValueError(
          f'labels {labels.shape} vs predictions {predictions.shape}')
    pos = predictions[labels > 0.5]
    neg = predictions[labels <= 0.5]
    # TP(t) = count(pos > t), by searchsorted over the sorted scores
    self.true_positives += len(pos) - np.searchsorted(
        np.sort(pos), self.thresholds, side='right')
    self.false_positives += len(neg) - np.searchsorted(
        np.sort(neg), self.thresholds, side='right')
    self.pos_count += len(pos)
    self.neg_count += len(neg)

  def result(self) -> float:
    if self.pos_count == 0 or self.neg_count == 0:
      return 0.0
    tpr = self.true_positives / self.pos_count
    fpr = self.false_positives / self.neg_count
    # thresholds ascend so (fpr, tpr) descend; trapezoid over the curve
    return float(np.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0))


def exact_auc(labels, predictions) -> float:
  """Exact ROC AUC by rank statistic (ties share their average rank)."""
  labels = np.asarray(labels, np.float64).reshape(-1)
  predictions = np.asarray(predictions, np.float64).reshape(-1)
  order = np.argsort(predictions)
  ranks = np.empty_like(order, dtype=np.float64)
  sorted_preds = predictions[order]
  ranks[order] = np.arange(1, len(predictions) + 1)
  i = 0
  while i < len(sorted_preds):
    j = i
    while j + 1 < len(sorted_preds) and sorted_preds[j + 1] == sorted_preds[i]:
      j += 1
    if j > i:
      ranks[order[i:j + 1]] = (i + j) / 2.0 + 1
    i = j + 1
  n_pos = labels.sum()
  n_neg = len(labels) - n_pos
  if n_pos == 0 or n_neg == 0:
    return 0.0
  return float(
      (ranks[labels > 0.5].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
