"""The frame plans at lambdas that are not a function of the QP, against the
JAX package's: under rate control the plans price with the R-lambda
model's lambda, which the model clips to [0.1, 10000], while the QP that
quantises comes from the model separately.  The packed intra plan and the
packed P and B plans at both ends of that range and at a model lambda of a
1080p P picture, exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_inter_plan as TP
import test_torch_inter_plan_b as TB
from hm16_2_tpu.encode import intra_rd as RR
from hm16_2_tpu_torch.encode import intra_rd as PR
from test_torch_inter_plan import _assert_plan_equal

torch.set_num_threads(1)

# the ends of ratectrl's lambda clip, and the model's lambda of the first P
# picture of a 1080p low-delay P stream at 4 Mbit/s (QP 32)
LAMS = [0.1, 81.4860517937966, 10000.0]


def _f32(x):
    return float(np.float32(x))


@pytest.mark.parametrize("lam", LAMS)
def test_intra_plan_at_model_lambda(lam):
    """The AI plan of a 136x72 8-bit picture at QP 27."""
    rng = np.random.default_rng(5)
    y = rng.integers(0, 256, (72, 136)).astype(np.int32)
    cb, cr = (rng.integers(0, 256, (36, 68)).astype(np.int32)
              for _ in range(2))
    kw = dict(h=72, w=136, bd=8, cbd=8, strong=True, qp=27, cqp0=26,
              cqp1=25, chroma=True)
    cw = _f32(2 ** (1 / 3))
    ref = np.asarray(RR._plan_device(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr),
        jnp.float32(_f32(lam)), jnp.float32(cw), None, use_stage1=False,
        **kw))
    got = PR._plan_device(torch.as_tensor(y), torch.as_tensor(cb),
                          torch.as_tensor(cr), _f32(lam), cw, **kw)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("lam", LAMS)
def test_p_plan_at_model_lambda(monkeypatch, lam):
    """The P plan of test_torch_inter_plan with four references, 136x72
    8-bit at QP 32."""
    monkeypatch.setattr(TP, "_lam", lambda qp: (_f32(lam),
                                                _f32(np.sqrt(lam))))
    cur, refs, mvn16 = TP._inputs(72, 136, 8)
    _assert_plan_equal(TP._port_plan(cur, refs, mvn16, 4, 32, 8),
                       TP._ref_plan(cur, refs, mvn16, 4, 32, 8))


@pytest.mark.parametrize("lam", LAMS)
def test_b_plan_at_model_lambda(monkeypatch, lam):
    """The B plan of test_torch_inter_plan_b with two past and two future
    references, 136x72 8-bit at QP 32."""
    monkeypatch.setattr(TB, "_lam", lambda qp: (_f32(lam),
                                                _f32(np.sqrt(lam))))
    cur, refs, dists, mvn16 = TB._inputs(72, 136, 8)
    lists = TB.LISTS["2x2"]
    _assert_plan_equal(TB._port_plan(cur, refs, dists, mvn16, lists, 32, 8),
                       TB._ref_plan(cur, refs, dists, mvn16, lists, 32, 8))
