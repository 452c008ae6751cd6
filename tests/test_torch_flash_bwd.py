"""The port's flash-attention backward against the JAX package.

On the CPU the port's wrapper runs its plain version
(`flash_attention_bwd_reference`), which is held here to the Pallas backward
kernel run in interpret mode, at the shapes of the L=128 training path
(small B), masked and unmasked, and with a fully masked row. The port's
autograd Function is held to `jax.vjp` of the JAX `dot_product_attention`
with `use_pallas=True`, on the kernel route and on the tk % 64 != 0
fallback. f32 throughout; tolerances are stated per test. The CUDA kernel
itself is held to the plain version in test_torch_gpu.py, on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import text2protein_tpu.ops.attention as jattn
import text2protein_tpu.ops.flash as jflash
from text2protein_tpu_torch.ops import attention as tattn
from text2protein_tpu_torch.ops import flash as tflash

# (H, Tq, Tk, D, masked): the attention calls of one training step at
# L=128 whose backward takes the kernel (AttnBlock, transformer self- and
# cross-attention at 16x16, cross-attention of the 4x4 mid block)
KERNEL_SHAPES = [
    (1, 256, 256, 256, False),
    (8, 256, 256, 32, False),
    (8, 256, 64, 32, True),
    (8, 16, 64, 32, True),
]
# ... and those whose backward recomputes the einsum path (Tk = 16)
FALLBACK_SHAPES = [
    (1, 16, 16, 256, False),
    (8, 16, 16, 32, False),
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
    monkeypatch.setattr(
        jflash, "flash_attention_bwd", jflash.flash_attention_bwd.__wrapped__
    )
    yield


def _inputs(b, h, tq, tk, d, masked, seed=0, dead_row=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, d)).astype(np.float32)
    g = rng.standard_normal((b, h, tq, d)).astype(np.float32)
    mask = None
    if masked or dead_row:
        lengths = rng.integers(1, tk + 1, size=b)
        lengths[0] = min(tk, 37)
        if dead_row:
            lengths[-1] = 0
        mask = np.arange(tk)[None, :] < lengths[:, None]
    return q, k, v, g, mask


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _jax_bwd(q, k, v, g, mask, scale):
    out, lse = jflash.flash_attention_fwd(_j(q), _j(k), _j(v), scale=scale,
                                          kv_mask=_j(mask))
    grads = jflash.flash_attention_bwd(_j(q), _j(k), _j(v), out, lse, _j(g),
                                       scale=scale, kv_mask=_j(mask))
    return np.asarray(out), np.asarray(lse), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("h,tq,tk,d,masked", KERNEL_SHAPES)
def test_reference_matches_pallas_bwd_kernel(interpret_pallas, h, tq, tk, d,
                                             masked):
    """Same residuals (the JAX forward's out and lse) into both backwards:
    dq, dk, dv within atol/rtol 1e-5 (f32, sums over at most 256 terms in
    another order)."""
    q, k, v, g, mask = _inputs(2, h, tq, tk, d, masked)
    scale = d**-0.5
    out, lse, want = _jax_bwd(q, k, v, g, mask, scale)
    got = tflash.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(out), _t(lse), _t(g), scale=scale,
        kv_mask=_t(mask))
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == w.shape, name
        np.testing.assert_allclose(x.numpy(), w, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


def test_fully_masked_row_matches_pallas_bwd_kernel(interpret_pallas):
    """A batch row with every key masked: the forward gives out = 0 and
    lse ~ -1e30, and the JAX backward adds the bias before the exp and does
    not multiply P by the mask, so P = 1 on every key and the gradients of
    that row are not zero. The port reproduces those numbers (atol/rtol
    1e-5) instead of zeroing them."""
    h, tq, tk, d = 8, 16, 64, 32
    q, k, v, g, mask = _inputs(2, h, tq, tk, d, True, seed=4, dead_row=True)
    assert not mask[-1].any()
    scale = d**-0.5
    out, lse, want = _jax_bwd(q, k, v, g, mask, scale)
    assert np.all(out[-1] == 0) and np.all(lse.reshape(2, h, tq)[-1] < -1e29)
    got = tflash.flash_attention_bwd_reference(
        _t(q), _t(k), _t(v), _t(out), _t(lse), _t(g), scale=scale,
        kv_mask=_t(mask))
    # P = 1 on the dead row: dV of its keys is the sum of dO over queries
    np.testing.assert_allclose(
        got[2][-1].numpy(),
        np.broadcast_to(g[-1].sum(axis=1, keepdims=True), (h, tk, d)),
        atol=1e-4, rtol=1e-5)
    assert np.abs(want[0][-1]).max() > 0.1
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), w, atol=1e-5, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("h,tq,tk,d,masked",
                         KERNEL_SHAPES + FALLBACK_SHAPES)
def test_autograd_function_matches_jax_vjp(interpret_pallas, h, tq, tk, d,
                                           masked):
    """The port's `dot_product_attention` under autograd against `jax.vjp`
    of the JAX one with use_pallas=True: the kernel route where
    `supports_bwd` holds, the einsum-recompute fallback at Tk = 16. Output
    and gradients within atol/rtol 1e-5."""
    q, k, v, g, mask = _inputs(2, h, tq, tk, d, masked, seed=2)
    scale = d**-0.5
    jmask = _j(mask)

    def jfn(q_, k_, v_):
        return jattn.dot_product_attention(q_, k_, v_, scale=scale,
                                           kv_mask=jmask, use_pallas=True)

    want_out, vjp = jax.vjp(jfn, _j(q), _j(k), _j(v))
    want = vjp(_j(g))
    tq_, tk_, tv_ = (_t(x).requires_grad_() for x in (q, k, v))
    bwd_before = tflash.flash_attention_bwd.launches
    out = tattn.dot_product_attention(tq_, tk_, tv_, scale=scale,
                                      kv_mask=_t(mask))
    got = torch.autograd.grad(out, (tq_, tk_, tv_), _t(g))
    # the CPU takes the plain versions, so no kernel launch is counted
    assert tflash.flash_attention_bwd.launches == bwd_before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=1e-5)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_autograd_takes_the_bwd_wrapper_only_where_the_gate_holds(
        monkeypatch):
    """The backward calls `flash_attention_bwd` on the kernel route and not
    on the fallback; the mask gets no gradient."""
    calls = []
    orig = tflash.flash_attention_bwd

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr(tflash, "flash_attention_bwd", spy)
    for (h, tq, tk, d, masked), routed in ((KERNEL_SHAPES[2], True),
                                           (FALLBACK_SHAPES[1], False)):
        q, k, v, g, mask = _inputs(1, h, tq, tk, d, masked)
        xs = [_t(x).requires_grad_() for x in (q, k, v)]
        out = tattn.dot_product_attention(*xs, kv_mask=_t(mask))
        out.backward(_t(g))
        assert all(x.grad is not None for x in xs)
        assert (len(calls) == 1) == routed
        calls.clear()


@pytest.mark.parametrize("shape_q,shape_k", [
    ((2, 1, 256, 256), (2, 1, 256, 256)),
    ((2, 8, 256, 32), (2, 8, 256, 32)),
    ((2, 8, 256, 32), (2, 8, 64, 32)),
    ((2, 1, 16, 256), (2, 1, 16, 256)),
    ((2, 8, 16, 32), (2, 8, 16, 32)),
    ((2, 8, 16, 32), (2, 8, 64, 32)),
    ((1, 1, 24, 8), (1, 1, 128, 8)),       # ragged Tq, D = 8: taken
    ((1, 1, 64, 1024), (1, 1, 64, 1024)),  # D = 1024: taken
    ((1, 1, 12, 32), (1, 1, 64, 32)),      # Tq % 8 != 0: refused
    ((1, 1, 64, 32), (1, 1, 72, 32)),      # Tk % 64 != 0: refused
    ((1, 1, 4096, 64), (1, 1, 4096, 64)),  # over the 10 MB budget: refused
    ((1, 1, 64, 12), (1, 1, 64, 12)),      # D % 8 != 0: refused
])
def test_supports_bwd_matches_jax(shape_q, shape_k):
    jq, jk = jnp.zeros(shape_q), jnp.zeros(shape_k)
    tq, tk = torch.zeros(shape_q), torch.zeros(shape_k)
    assert tflash.supports_bwd(tq, tk, tk) == jflash.supports_bwd(jq, jk, jk)


@pytest.mark.parametrize("shape_q,shape_k", [
    ((2, 1, 256, 256), (2, 1, 256, 256)),
    ((2, 8, 256, 32), (2, 8, 64, 32)),
    ((2, 1, 16, 256), (2, 1, 16, 256)),    # Tk % 64 != 0
    ((2, 8, 16, 32), (2, 8, 64, 32)),
    ((1, 1, 12, 32), (1, 1, 64, 32)),      # Tq % 8 != 0
    ((1, 1, 64, 32), (1, 1, 72, 32)),      # Tk % 64 != 0
    ((1, 1, 4096, 64), (1, 1, 4096, 64)),  # over the 10 MB budget
    ((1, 1, 64, 12), (1, 1, 64, 12)),      # D % 8 != 0: refused by both
    ((1, 1, 4, 32), (1, 1, 64, 32)),       # Tq < 8: refused by both
    ((1, 1, 264, 32), (1, 1, 64, 32)),     # no clean q block: refused
])
@pytest.mark.parametrize("masked", [True, False])
def test_cuda_bwd_gate(shape_q, shape_k, masked):
    """The CUDA route's backward gate is a function of the shapes and of
    whether a mask is given: `supports_bwd` with a mask, `supports`
    without one."""
    q, k = torch.zeros(shape_q), torch.zeros(shape_k)
    got = tflash.supports_bwd_cuda(q, k, k, masked)
    want = (tflash.supports_bwd(q, k, k) if masked
            else tflash.supports(q, k, k))
    assert got == want
    assert tflash.supports_bwd(q, k, k) <= got <= tflash.supports(q, k, k)


def test_cpu_tensor_takes_plain_bwd_without_launch():
    q, k, v, g, mask = _inputs(1, 8, 16, 64, 32, True)
    out, lse = tflash.flash_attention_fwd_reference(_t(q), _t(k), _t(v),
                                                    kv_mask=_t(mask))
    before = tflash.flash_attention_bwd.launches
    got = tflash.flash_attention_bwd(_t(q), _t(k), _t(v), out, lse, _t(g),
                                     kv_mask=_t(mask))
    want = tflash.flash_attention_bwd_reference(_t(q), _t(k), _t(v), out,
                                                lse, _t(g), kv_mask=_t(mask))
    assert tflash.flash_attention_bwd.launches == before
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, atol=0, rtol=0)


def test_bwd_refuses_other_devices():
    q = torch.zeros((1, 1, 16, 32), device="meta")
    lse = torch.zeros((1, 16, 1), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention_bwd(q, q, q, q, lse, q)
