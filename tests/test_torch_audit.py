"""The port's state auditor against the JAX package's, on the CPU.

- ``digest_u32`` equals JAX ``_digest_u32`` bit for bit on f32, bf16,
  int32 and uint8 leaves, across the port's reduction chunks.
- On the same poisoned hybrid state (NaN and Inf in an accumulator, a
  table and dense leaves, an MLP kernel among them), the port's findings
  equal JAX's: check, leaf name, devices and rows.
- ``LossSpikeGate`` gives JAX's verdicts on the same series.
- A healthy state gives no finding; rotating windows under a byte budget
  find a poisoned row within ``full_coverage_audits`` audits; the checks
  the port defers name their items.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from distributed_embeddings_tpu.parallel import audit as jax_audit
from distributed_embeddings_tpu.parallel import checkpoint as jax_ckpt
from distributed_embeddings_tpu.parallel import planner as jax_planner
from distributed_embeddings_tpu.parallel import sparse as jax_sparse
from distributed_embeddings_tpu.parallel.dist_embedding import (
    DistributedEmbedding as JaxDistributedEmbedding)
from distributed_embeddings_tpu_torch import optim
from distributed_embeddings_tpu_torch.parallel import audit
from distributed_embeddings_tpu_torch.parallel import checkpoint
from distributed_embeddings_tpu_torch.parallel import sparse
from distributed_embeddings_tpu_torch.parallel.dist_embedding import (
    DistributedEmbedding)
from distributed_embeddings_tpu_torch.parallel.planner import TableConfig
from distributed_embeddings_tpu_torch.utils import resilience

import torch_parity

torch.set_num_threads(1)

SPECS = torch_parity.MIXED_SPECS


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'int32', 'uint8'])
@pytest.mark.parametrize('chunk', [None, 1000])
def test_digest_equals_jax_bit_for_bit(dtype, chunk, monkeypatch):
  if chunk is not None:
    monkeypatch.setattr(audit, '_CHUNK', chunk)
  rng = np.random.default_rng(3)
  if dtype in ('int32', 'uint8'):
    info = np.iinfo(dtype)
    a = rng.integers(info.min, info.max, size=(977, 13), dtype=dtype)
    t = torch.from_numpy(a.copy())
  else:
    a = rng.normal(scale=1e3, size=(977, 13)).astype(np.float32)
    a[0, :3] = [np.nan, np.inf, -0.0]
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    # both packages hash the same bits (the casts may differ on NaN
    # payloads): the JAX array is made from the tensor's bit pattern
    if dtype == 'bfloat16':
      a = jax.lax.bitcast_convert_type(
          jnp.asarray(t.view(torch.int16).numpy()), jnp.bfloat16)
  want = int(jax_audit._digest_u32(jnp.asarray(a, getattr(jnp, dtype))))
  assert int(audit.digest_u32(t)) == want
  # one flipped bit anywhere changes it
  bits = t.view(torch.uint8).reshape(-1)
  bits[12345] ^= 4
  assert int(audit.digest_u32(t)) != want


def _pair_state(seed=0):
  """The same hybrid state in both packages (SparseAdagrad, adagrad on a
  kernel and a two-layer MLP)."""
  jd = JaxDistributedEmbedding(
      [jax_planner.TableConfig(r, w, combiner=c) for r, w, c, _ in SPECS],
      mesh=torch_parity.jax_mesh(1), packed_storage=False,
      strategy='memory_balanced')
  pd = DistributedEmbedding(
      [TableConfig(r, w, combiner=c) for r, w, c, _ in SPECS],
      device='cpu', strategy='memory_balanced')
  rng = np.random.default_rng(seed)
  tables = [rng.normal(size=(r, w)).astype(np.float32)
            for r, w, _, _ in SPECS]
  dense = {'kernel': rng.normal(size=(6, 1)).astype(np.float32),
           'mlp': [{'kernel': rng.normal(size=(6, 5)).astype(np.float32),
                    'bias': rng.normal(size=(5,)).astype(np.float32)}]}
  jemb, pemb = jax_sparse.SparseAdagrad(0.1), sparse.SparseAdagrad(0.1)
  jstate = jax_sparse.init_hybrid_train_state(
      jd, {'embedding': jax_ckpt.set_weights(jd, tables),
           **jax.tree.map(jnp.asarray, dense)}, optax.adagrad(0.1), jemb)
  pstate = sparse.init_hybrid_train_state(
      pd, {'embedding': checkpoint.set_weights(pd, tables),
           'kernel': torch.tensor(dense['kernel']),
           'mlp.layers.0.weight': torch.tensor(dense['mlp'][0]['kernel'].T),
           'mlp.layers.0.bias': torch.tensor(dense['mlp'][0]['bias'])},
      optim.adagrad(0.1), pemb)
  return jd, jstate, pd, pstate


def _key(f):
  return (f.check, f.leaf, tuple(f.devices), tuple(f.rows))


def test_nonfinite_findings_match_jax():
  jd, jstate, pd, pstate = _pair_state()
  # the same damage in both: accumulator rows 3 and 17 of group 0, table
  # row 5 of group 1, a kernel row and an MLP kernel element
  jacc = np.array(jstate.opt_state[1]['group_0']['acc'])
  jtab = np.array(jstate.params['embedding']['group_1'])
  for a, (row, col, v) in ((jacc, (3, 1, np.nan)), (jacc, (17, 0, np.inf)),
                           (jtab, (5, 2, -np.inf))):
    a[0, row, col] = v
  jparams = dict(jstate.params)
  jparams['embedding'] = dict(jparams['embedding'], group_1=jnp.asarray(jtab))
  jparams['kernel'] = jparams['kernel'].at[2, 0].set(jnp.nan)
  mlp = [dict(jparams['mlp'][0])]
  mlp[0]['kernel'] = mlp[0]['kernel'].at[4, 1].set(jnp.nan)
  jparams['mlp'] = mlp
  emb_opt = {g: dict(d) for g, d in jstate.opt_state[1].items()}
  emb_opt['group_0']['acc'] = jnp.asarray(jacc)
  jbad = jstate._replace(params=jparams,
                         opt_state=(jstate.opt_state[0], emb_opt))
  with torch.no_grad():
    pstate.opt_state[1]['group_0']['acc'][3, 1] = float('nan')
    pstate.opt_state[1]['group_0']['acc'][17, 0] = float('inf')
    pstate.params['embedding']['group_1'][5, 2] = float('-inf')
    pstate.params['kernel'][2, 0] = float('nan')
    pstate.params['mlp.layers.0.weight'][1, 4] = float('nan')  # [out, in]
  want = jax_audit.StateAuditor(jd, every=1, bytes_per_audit=None
                                ).check_state(jbad, step=3)
  resilience.clear_recent()
  aud = audit.StateAuditor(pd, every=1, bytes_per_audit=None)
  got = aud.check_state(pstate, step=3)
  assert sorted(map(_key, got)) == sorted(map(_key, want))
  assert len(got) == 4 and aud.findings_total == 4
  journaled = resilience.recent('audit_failure')
  assert {e['leaf'] for e in journaled} == {f.leaf for f in got}
  assert all(e['step'] == 3 for e in journaled)
  with pytest.raises(audit.AuditError, match='group_0/acc'):
    aud.assert_healthy(pstate)


def test_dense_scalar_nan_reports_row_zero():
  _, _, pd, _ = _pair_state()
  aud = audit.StateAuditor(pd, every=1)
  findings = aud.run(dense={'temp': torch.tensor(float('nan')),
                            'ok': torch.tensor(1.0)})
  assert len(findings) == 1 and findings[0].check == 'finite'
  assert findings[0].leaf == "dense['temp']" and findings[0].rows == (0,)


def test_loss_spike_gate_matches_jax():
  rng = np.random.default_rng(0)
  series = list(1.0 + 0.05 * rng.normal(size=60))
  series[20] = 40.0
  series[41] = 9.0
  series += [0.25] * 10 + [0.2500005, 250.0]
  for kw in ({}, {'zscore': 6.0, 'warmup': 5, 'decay': 0.9}):
    gate, jgate = audit.LossSpikeGate(**kw), jax_audit.LossSpikeGate(**kw)
    verdicts = [(gate.observe(v), jgate.observe(v)) for v in series]
    assert [a is None for a, _ in verdicts] == [b is None for _, b in
                                                verdicts]
    assert sum(a is not None for a, _ in verdicts) >= 2
    for a, b in verdicts:
      assert a == b
  with pytest.raises(ValueError, match='zscore'):
    audit.LossSpikeGate(zscore=0)


def test_healthy_state_no_findings_and_rotating_windows():
  _, _, pd, pstate = _pair_state()
  aud = audit.StateAuditor(pd, every=1)
  assert aud.check_state(pstate, step=1) == []
  aud.assert_healthy(pstate)
  assert aud.audits == 2 and aud.findings_total == 0
  budget = audit.StateAuditor(pd, every=1, bytes_per_audit=512)
  assert budget.check_state(pstate) == []
  assert budget.coverage_frac < 1.0 and budget.full_coverage_audits > 1
  with torch.no_grad():
    pstate.opt_state[1]['group_1']['acc'][-1, 0] = float('nan')
  seen = [bool(budget.check_state(pstate))
          for _ in range(budget.full_coverage_audits)]
  assert any(seen) and not all(seen)
  assert audit.StateAuditor(pd, every=1, bytes_per_audit=None).check_state(
      pstate)


def test_deferred_and_invalid_checks_raise():
  _, _, pd, pstate = _pair_state()
  # the quantized check is ported: on an unquantized plan it has no leaf
  assert audit.StateAuditor(pd, checks=('finite', 'quantized'),
                            bytes_per_audit=None).check_state(pstate) == []
  # so is the tier check (item 12, tests/test_torch_coldtier.py): a layer
  # without a cold tier has nothing for it
  assert audit.StateAuditor(pd, checks=('tier',),
                            bytes_per_audit=None).check_state(pstate) == []
  with pytest.raises(ValueError, match='unknown audit checks'):
    audit.StateAuditor(pd, checks=('finite', 'bogus'))
  with pytest.raises(ValueError, match='cadence'):
    audit.StateAuditor(pd, every=0)
  with pytest.raises(ValueError, match='bytes_per_audit'):
    audit.StateAuditor(pd, bytes_per_audit=0)


def test_tree_digests_name_every_leaf_and_see_one_bit():
  _, _, pd, pstate = _pair_state()
  want = audit.tree_digests(pstate)
  assert want['2'] == 0 and want['1/0/sum_of_squares/kernel'] > 0
  assert set(want) >= {'0/embedding/group_0', '1/1/group_0/acc',
                       '0/mlp.layers.0.weight'}
  bits = pstate.opt_state[1]['group_1']['acc'].view(torch.int32)
  bits[4, 1] ^= 1 << 7
  got = audit.tree_digests(pstate)
  assert [k for k in want if want[k] != got[k]] == ['1/1/group_1/acc']


def test_finite_screen_overflow_is_not_a_finding():
  """Rows of finite values whose f32 sum overflows fail the one-pass
  screen; the exact count clears them, so no finding (the checks stay
  one-sided), while a real NaN beside them is still found."""
  _, _, pd, pstate = _pair_state()
  acc = pstate.opt_state[1]['group_0']['acc']
  with torch.no_grad():
    acc[:4] = 3e38
  aud = audit.StateAuditor(pd, every=1, bytes_per_audit=None)
  assert not bool(audit._sums_finite(acc))
  assert aud.check_state(pstate) == []
  with torch.no_grad():
    acc[9, 2] = float('nan')
  found = aud.check_state(pstate)
  assert [(f.leaf, f.rows) for f in found] == [('group_0/acc', (9,))]
