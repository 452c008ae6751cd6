"""The port's flash-attention forward against the JAX package.

On the CPU the port's wrapper runs its plain version
(`flash_attention_fwd_reference`), which is held here to the Pallas kernel
run in interpret mode, at the shapes of the L=128 serving path (small B),
f32, atol/rtol 1e-5. The CUDA kernel itself is held to the plain version in
test_torch_gpu.py, on the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import text2protein_tpu.ops.flash as jflash
from text2protein_tpu.ops.attention import _xla_attention as j_xla_attention
from text2protein_tpu_torch.ops import attention as tattn
from text2protein_tpu_torch.ops import flash as tflash

# (H, Tq, Tk, D, masked): the attention calls of one score evaluation at
# L=128: AttnBlock, transformer self- and cross-attention at 16x16, and the
# same three in the 4x4 mid block.
PATH_SHAPES = [
    (1, 256, 256, 256, False),
    (8, 256, 256, 32, False),
    (8, 256, 64, 32, True),
    (1, 16, 16, 256, False),
    (8, 16, 16, 32, False),
    (8, 16, 64, 32, True),
]


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        jflash.pl, "pallas_call", functools.partial(orig, interpret=True)
    )
    monkeypatch.setattr(
        jflash, "flash_attention_fwd", jflash.flash_attention_fwd.__wrapped__
    )
    yield


def _inputs(b, h, tq, tk, d, masked, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    mask = None
    if masked:
        lengths = rng.integers(1, tk + 1, size=b)
        lengths[0] = min(tk, 37)
        mask = np.arange(tk)[None, :] < lengths[:, None]
    return q, k, v, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("h,tq,tk,d,masked", PATH_SHAPES)
def test_reference_matches_pallas_kernel(interpret_pallas, h, tq, tk, d,
                                         masked):
    q, k, v, mask = _inputs(2, h, tq, tk, d, masked)
    scale = d**-0.5
    want_o, want_l = jflash.flash_attention_fwd(
        _j(q), _j(k), _j(v), scale=scale, kv_mask=_j(mask))
    got_o, got_l = tflash.flash_attention_fwd_reference(
        _t(q), _t(k), _t(v), scale=scale, kv_mask=_t(mask))
    assert got_o.shape == (2, h, tq, d) and got_l.shape == (2 * h, tq, 1)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               atol=1e-5, rtol=1e-5)


def test_fully_masked_row_gives_zero(interpret_pallas):
    """A batch row whose keys are all masked gives 0 in both packages (the
    kernel's rule; the einsum path gives NaN there)."""
    q, k, v, _ = _inputs(2, 8, 16, 64, 32, False, seed=3)
    mask = np.ones((2, 64), bool)
    mask[1] = False
    want_o, want_l = jflash.flash_attention_fwd(
        _j(q), _j(k), _j(v), scale=32**-0.5, kv_mask=_j(mask))
    got_o, got_l = tflash.flash_attention_fwd_reference(
        _t(q), _t(k), _t(v), scale=32**-0.5, kv_mask=_t(mask))
    assert np.all(np.asarray(want_o)[1] == 0)
    assert torch.all(got_o[1] == 0)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("h,tq,tk,d,masked", PATH_SHAPES + [
    (2, 7, 16, 32, False),    # Tq < 8: outside `supports`, einsum path
    (2, 64, 64, 12, True),    # D % 8 != 0: einsum path
])
def test_dot_product_attention_matches_xla(h, tq, tk, d, masked):
    q, k, v, mask = _inputs(2, h, tq, tk, d, masked, seed=1)
    want = j_xla_attention(_j(q), _j(k), _j(v), d**-0.5, kv_mask=_j(mask))
    got = tattn.dot_product_attention(_t(q), _t(k), _t(v), kv_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("shape_q,shape_k", [
    ((1, 1, 64, 32), (1, 1, 64, 32)),
    ((1, 1, 7, 32), (1, 1, 64, 32)),
    ((1, 1, 64, 12), (1, 1, 64, 12)),
    ((1, 1, 64, 1032), (1, 1, 64, 1032)),
    ((1, 2, 600, 32), (1, 2, 64, 32)),
    ((2, 8, 256, 32), (2, 8, 64, 32)),
])
def test_supports_matches_jax(shape_q, shape_k):
    jq, jk = jnp.zeros(shape_q), jnp.zeros(shape_k)
    tq, tk = torch.zeros(shape_q), torch.zeros(shape_k)
    assert tflash.supports(tq, tk, tk) == jflash.supports(jq, jk, jk)


def test_cpu_tensor_takes_plain_version_without_launch():
    q, k, v, mask = _inputs(1, 8, 16, 64, 32, True)
    before = tflash.flash_attention_fwd.launches
    got = tflash.flash_attention_fwd(_t(q), _t(k), _t(v), kv_mask=_t(mask))
    want = tflash.flash_attention_fwd_reference(_t(q), _t(k), _t(v),
                                                kv_mask=_t(mask))
    assert tflash.flash_attention_fwd.launches == before
    torch.testing.assert_close(got[0], want[0], atol=0, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=0, rtol=0)


def test_other_devices_are_refused():
    q = torch.zeros((1, 1, 16, 32), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention_fwd(q, q, q)
