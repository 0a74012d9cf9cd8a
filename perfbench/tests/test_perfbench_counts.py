"""The benchmark's FLOP and byte counts against figures worked by hand."""

import numpy as np

from perfbench.counts import dlrm, embedding, synthetic


def test_dlrm_head_flops_by_hand():
  # 3 features (bottom + 2 tables) of width 4: 3 pairs + 4 = 7 top inputs;
  # layers 3->8 (no input gradient), 8->4, 7->6, 6->1 at batch 2
  cfg = {'table_sizes': [10, 10], 'embedding_dim': 4,
         'bottom_mlp_dims': [8, 4], 'top_mlp_dims': [6, 1],
         'num_numerical_features': 3}
  fwd = 2 * 2 * (3 * 8 + 8 * 4 + 7 * 6 + 6 * 1)       # 416
  inter = 2 * 2 * 3 * 3 * 4                           # 144
  assert dlrm.head_flops(cfg, 2, train=False) == fwd + inter == 560
  bwd = 2 * 2 * (3 * 8 + 2 * 8 * 4 + 2 * 7 * 6 + 2 * 6 * 1)  # 736
  assert dlrm.head_flops(cfg, 2, train=True) == fwd + bwd + 3 * inter == 1584


def test_synthetic_head_flops_by_hand():
  # one shared table of width 4 read by two inputs: 8 + 2 numerical = 10
  cfg = {'embedding_configs': [{'num_tables': 1, 'nnz': [1, 2],
                                'num_rows': 10, 'width': 4,
                                'shared': True}],
         'mlp_sizes': [3], 'num_numerical_features': 2,
         'interact_stride': None}
  assert synthetic.head_flops(cfg, 2, train=False) == 2 * 2 * (30 + 3)
  assert synthetic.head_flops(cfg, 2, train=True) == 3 * 132


BATCH = {'cats': [np.array([1, 1, 2]), np.array([0, 5, 5])]}
TABLES = [(10, 4), (10, 4)]


def test_lookup_bytes_by_hand():
  # ids 6 x 4 B; distinct rows {1, 2} and {0, 5}: 4 x 4 x 2 B; outputs
  # 2 inputs x 3 samples x 4 x 4 B
  got = embedding.lookup_bytes(BATCH, TABLES, [0, 1], 2, 4)
  assert got == 24 + 32 + 96


def test_apply_bytes_by_hand():
  # ids 24 B; cotangents 2 x 3 x 4 x 2 B; 4 touched rows read and written
  # with a 4 B state element beside each 2 B table element
  got = embedding.apply_bytes(BATCH, TABLES, [0, 1], 2, 2, 4)
  assert got == 24 + 48 + 2 * 4 * 4 * (2 + 4)


def test_shared_table_counts_its_rows_once():
  batch = {'cats': [np.array([3, 4]), np.array([[3, 3], [4, 9]])]}
  assert embedding.distinct_rows(batch, [0, 0]) == {0: 3}
