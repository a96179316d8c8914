"""Per-row top-2 classes of the PyTorch port vs the JAX package (CPU).

``top2_classes_plain`` (what ``top2_classes`` computes for CPU tensors) is
held against ``top2_reference_xla`` and against the Pallas kernel
``pallas_top2_classes`` run in interpret mode, on the same numpy logits,
bit for bit: values, class ids, tie order. The CUDA kernel itself is tested
on the card by tests/test_torch_cuda.py.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_retinanet_tpu.kernels.select_pallas import pallas_top2_classes, top2_reference_xla
from pytorch_retinanet_tpu_torch.kernels import top2_classes, top2_classes_plain


def _port(x: np.ndarray, dtype=torch.bfloat16):
    out = top2_classes(torch.from_numpy(np.array(x)).to(dtype))
    assert [t.dtype for t in out] == [torch.float32, torch.int32] * 2
    return [t.numpy() for t in out]


def _assert_equal(got, want):
    for name, g, w in zip(("v1", "c1", "v2", "c2"), got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


# The JAX package's kernel test shapes, rows that fill no tile of 8 or 1024,
# and one class.
@pytest.mark.parametrize("a,c", [(9450, 90), (1512, 90), (700, 13), (64, 128), (40, 7),
                                 (13, 90), (1001, 37), (8, 1)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_equals_jax_reference_and_kernel(a, c, dtype):
    x = np.random.default_rng(a + c).normal(-4.0, 2.0, (a, c)).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = _port(np.asarray(xj.astype(jnp.float32)), getattr(torch, dtype))
    _assert_equal(got, top2_reference_xla(xj))
    if dtype == "bfloat16":
        _assert_equal(got, pallas_top2_classes(xj, interpret=True))


def test_ties_break_to_the_lower_class():
    x = np.zeros((24, 17), np.float32)
    x[:, 3] = x[:, 11] = 5.0
    x[:8, 0] = 5.0  # three-way tie: 0 then 3
    got = _port(x)
    _assert_equal(got, pallas_top2_classes(jnp.asarray(x).astype(jnp.bfloat16), interpret=True))
    assert (got[1][:8] == 0).all() and (got[3][:8] == 3).all()
    assert (got[1][8:] == 3).all() and (got[3][8:] == 11).all()


def test_constant_rows_and_extremes():
    """All-equal rows (the second is the next id), -inf, and values below the
    -3e38 fill of the second scan."""
    x = np.zeros((16, 5), np.float32)
    x[8:] = -np.inf
    x[12:, 2] = -3.3e38
    _assert_equal(_port(x, torch.float32), top2_reference_xla(jnp.asarray(x)))


def test_too_few_rows_raise_like_jax():
    with pytest.raises(ValueError):
        pallas_top2_classes(jnp.zeros((7, 9)), interpret=True)
    with pytest.raises(ValueError):
        top2_classes(torch.zeros((7, 9)))
    with pytest.raises(ValueError):
        top2_classes(torch.zeros((8, 9, 1)))


def test_plain_takes_a_level_of_head_logits():
    """[B, A_l, C] head logits reshaped to [B * A_l, C], as a postprocess would."""
    logits = torch.randn((2, 693, 90), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    v1, c1, v2, c2 = top2_classes_plain(logits.reshape(-1, 90))
    top = torch.topk(logits.reshape(-1, 90).float(), 2, dim=1)
    torch.testing.assert_close(torch.stack([v1, v2], 1), top.values, rtol=0, atol=0)
    assert (v1 >= v2).all() and (c1 != c2).all()
