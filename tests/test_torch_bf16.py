"""The port in bf16 (`model.dtype: bfloat16`) against the JAX package, on the
CPU.

- Flash attention on bf16 inputs: the port's plain versions (the CPU route
  of its bf16 kernels) against the JAX Pallas kernels run in interpret
  mode, as tests/test_flash.py runs them. Both upcast to f32, compute in
  f32 and round each output once, so they differ by the order of f32 sums:
  out, dq, dk and dv within one bf16 rounding step of each tensor's scale,
  lse within 1e-5.
- The tiny UNet and the DSM loss in bf16 with `norm_dtype` bfloat16,
  against the JAX model with the same params (its attention through its
  Pallas kernels, interpreted). The bound is calibrated on the JAX package
  itself: the port's bf16 result may differ from JAX's bf16 result by at
  most half of what JAX's bf16 result differs from its own f32 result on
  the same inputs. A port that rounded at other places than JAX (or not at
  all) would sit at about that whole difference. The gradients are in
  tests/test_torch_bf16_grad.py.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import text2protein_tpu.ops.attention as jattn
import text2protein_tpu.ops.flash as jflash
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.diffusion.losses import (
    get_sde_loss_fn as j_get_sde_loss_fn,
)
from text2protein_tpu.diffusion.sde import get_sde as j_get_sde
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.diffusion.losses import get_sde_loss_fn
from text2protein_tpu_torch.diffusion.sde import get_sde
from text2protein_tpu_torch.interop.from_jax import (
    state_dict_from_flax_params,
)
from text2protein_tpu_torch.models import layers as tlayers
from text2protein_tpu_torch.models.unet import build_model
from text2protein_tpu_torch.ops import flash as tflash

from torch_port_helpers import (
    C,
    CONTEXT_DIM,
    N,
    flax_template,
    random_flax_params,
    rel_max_diff,
    tiny_config_dict,
)

BF16 = {"dtype": "bfloat16", "norm_dtype": "bfloat16"}


def _patch_pallas(mp):
    """The JAX package's attention through its Pallas kernels, interpreted
    on the CPU."""
    orig = pl.pallas_call
    mp.setattr(jflash.pl, "pallas_call",
               functools.partial(orig, interpret=True))
    mp.setattr(jflash, "flash_attention_fwd",
               jflash.flash_attention_fwd.__wrapped__)
    mp.setattr(jflash, "flash_attention_bwd",
               jflash.flash_attention_bwd.__wrapped__)
    jattn.set_backend("pallas")


@pytest.fixture()
def jax_pallas(monkeypatch):
    _patch_pallas(monkeypatch)
    yield
    jattn.set_backend(None)


def bf16_step(scale):
    """One bf16 rounding step (ulp) at the magnitude `scale`."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _qkv(seed, b, h, tq, tk, d, masked, dead_row):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32)
               for t in (tq, tk, tk))
    # round to bf16 once, so both packages get the same bf16 numbers
    q, k, v = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
               for a in (q, k, v))
    mask = None
    if masked:
        lengths = rng.integers(1, tk + 1, size=b)
        mask = np.arange(tk)[None, :] < lengths[:, None]
        if dead_row:
            mask[-1] = False
    return q, k, v, mask


def _t(a):
    """A bf16 numpy array (ml_dtypes) as a torch bf16 tensor."""
    return torch.from_numpy(np.array(a, np.float32)).bfloat16()


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


# (B, H, Tq, Tk, D, masked, fully masked batch row): tile edges of Tq, Tk
# and D (D % 16 == 8 at 8, 24 and 136), the 16-token caption bucket
FWD_CASES = [
    (2, 2, 64, 64, 32, False, False),
    (3, 1, 24, 40, 8, True, True),
    (2, 2, 100, 16, 64, True, True),
    (1, 1, 72, 136, 136, False, False),
]
# the JAX backward kernel's shapes (Tq % 8 == 0, Tk % 64 == 0)
BWD_CASES = [
    (2, 2, 64, 64, 32, True, True),
    (1, 1, 40, 128, 136, True, True),
    (2, 3, 16, 64, 24, False, False),
    (1, 1, 64, 64, 512, False, False),
]


@pytest.mark.parametrize("b,h,tq,tk,d,masked,dead", FWD_CASES)
def test_bf16_flash_fwd_matches_jax_kernel(jax_pallas, b, h, tq, tk, d,
                                           masked, dead):
    q, k, v, mask = _qkv(1, b, h, tq, tk, d, masked, dead)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    assert jq.dtype == jnp.bfloat16
    want, want_lse = jflash.flash_attention_fwd(
        jq, jk, jv, scale=d**-0.5,
        kv_mask=None if mask is None else jnp.asarray(mask))
    got, lse = tflash.flash_attention_fwd(
        _t(q), _t(k), _t(v), d**-0.5,
        None if mask is None else torch.from_numpy(mask))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert lse.dtype == torch.float32
    want = _f32(want)
    err = np.abs(_f32(got) - want).max()
    assert err <= bf16_step(np.abs(want).max()), err
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=1e-5,
                               rtol=0)
    if dead:
        assert (_f32(got)[-1] == 0).all()


@pytest.mark.parametrize("b,h,tq,tk,d,masked,dead", BWD_CASES)
def test_bf16_flash_bwd_matches_jax_kernel(jax_pallas, b, h, tq, tk, d,
                                           masked, dead):
    q, k, v, mask = _qkv(2, b, h, tq, tk, d, masked, dead)
    g = np.asarray(jnp.asarray(np.random.default_rng(3).standard_normal(
        q.shape).astype(np.float32)).astype(jnp.bfloat16))
    jmask = None if mask is None else jnp.asarray(mask)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    assert jflash.supports_bwd(jq, jk, jv)
    out, lse = jflash.flash_attention_fwd(jq, jk, jv, scale=d**-0.5,
                                          kv_mask=jmask)
    want = jflash.flash_attention_bwd(jq, jk, jv, out, lse, jg,
                                      scale=d**-0.5, kv_mask=jmask)
    got = tflash.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(_f32(out)),
        torch.from_numpy(np.array(lse)), _t(g), d**-0.5,
        None if mask is None else torch.from_numpy(mask))
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        w = _f32(w)
        assert np.isfinite(w).all()
        err = np.abs(_f32(x) - w).max()
        assert err <= bf16_step(np.abs(w).max()), (name, err)


# ------------------------------------------------- bf16 elementwise ops


ELEMENTWISE = {
    "swish": (jax.nn.silu, tlayers.swish),
    "gelu": (jax.nn.gelu, tlayers.gelu_tanh),
    "rescale": (lambda x: x / math.sqrt(2.0), tlayers.rescale),
    "dropout_scale": (lambda x: x / 0.9,
                      lambda x: x / tlayers.const(0.9, x.dtype)),
}


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_bf16_elementwise_op_rounds_as_jax(name):
    """The port's bf16 swish, tanh gelu, skip rescale and dropout scale
    equal jitted JAX's bit for bit on 1e5 values: XLA rounds every bf16 op
    and each Python constant to bf16, and so does the port (a fused
    `F.silu` or `F.gelu` rounds once: another function)."""
    jfn, tfn = ELEMENTWISE[name]
    x = (np.random.default_rng(5).standard_normal(100_000) * 3).astype(
        np.float32)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(x).astype(jnp.bfloat16))
                      .astype(jnp.float32))
    got = tfn(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


# ------------------------------------------------------------- the UNet


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, N, N, C)) * 5).astype(np.float32)
    labels = np.asarray([3.0, 70.0], np.float32)
    ctx = rng.standard_normal((2, 8, CONTEXT_DIM)).astype(np.float32)
    mask = np.ones((2, 8), bool)
    mask[0, 3:] = False
    return x, labels, ctx, mask


def _batch(seed):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (2, N, N, C)).astype(np.float32)
    row = np.arange(N)[None, :] < np.array([11, N])[:, None]
    mask_pair = row[:, :, None] & row[:, None, :]
    coords[..., -1] = mask_pair
    ctx_mask = np.ones((2, 64), bool)
    ctx_mask[0, 20:] = False
    batch = {
        "coords_6d": coords * mask_pair[..., None],
        "mask_pair": mask_pair,
        "context": rng.standard_normal((2, 64, CONTEXT_DIM)
                                       ).astype(np.float32),
        "context_mask": ctx_mask,
    }
    t = rng.uniform(0.05, 1.0, 2).astype(np.float32)
    z = rng.standard_normal((2, N, N, C)).astype(np.float32)
    return batch, t, z


LOSS_SEEDS = (4, 5, 6, 7)


def random_params():
    """Random flax params (proj_out included) of the tiny model; the same
    tree serves the f32 and the bf16 model (params stay f32)."""
    jmodel = j_build_model(j_load_config(tiny_config_dict()))
    return random_flax_params(flax_template(jmodel, *_inputs()), 0)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX model's score (`_inputs()`) and train-mode DSM loss of the
    LOSS_SEEDS batches (dropout 0, injected t and z), in f32 and in bf16,
    its attention through the Pallas kernels in interpret mode. The score
    is computed op by op (no jit), so every bf16 op rounds where the JAX
    code puts it; under jit XLA:CPU may keep fused bf16 intermediates in
    f32 (it allows excess precision), which moves its bf16 score by 1.2e-3
    of its scale here, about what the port's flips of summation order
    move it. The losses are jitted, as the JAX trainer runs them."""
    params = random_params()
    refs = {"params": params}
    with pytest.MonkeyPatch.context() as mp:
        _patch_pallas(mp)
        try:
            for name, model in (("f32", {}), ("bf16", BF16)):
                cfg = j_load_config(tiny_config_dict(**model))
                jmodel = j_build_model(cfg)
                x, labels, ctx, mask = (jnp.asarray(a) for a in _inputs())
                refs[f"score_{name}"] = np.asarray(jmodel.apply(
                    {"params": params}, x, labels, context=ctx,
                    context_mask=mask))
                jsde, _ = j_get_sde(cfg)
                loss = jax.jit(j_get_sde_loss_fn(jsde, jmodel, train=True,
                                                 condition=("length",)))
                losses = []
                for seed in LOSS_SEEDS:
                    batch, t, z = _batch(seed)
                    losses.append(float(loss(
                        params, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0), t=jnp.asarray(t),
                        z=jnp.asarray(z))))
                refs[f"loss_{name}"] = np.asarray(losses)
        finally:
            jattn.set_backend(None)
    return refs


def port_model(params, **model):
    cfg = load_config(tiny_config_dict(**model))
    tmodel = build_model(cfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax_params(params, cfg),
                           strict=True)
    return tmodel


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_bf16_unet_matches_jax_bf16(jax_refs, remat):
    """Measured on these inputs: JAX bf16 vs JAX f32, rel max diff 2.5e-3;
    the port's bf16 vs JAX bf16, 1.1e-3, within half of it. (The two bf16
    models agree bit for bit through the first six residual blocks; from
    there one-ulp flips from sums taken in another order spread.) With
    `remat` the port's resblocks are rematted and the forward runs with a
    gradient taken, so the checkpointed path is the one computed."""
    want, f32 = jax_refs["score_bf16"], jax_refs["score_f32"]
    assert want.dtype == np.float32  # the head is f32
    x, labels, ctx, mask = _inputs()
    tmodel = port_model(jax_refs["params"], remat_resblocks=remat, **BF16)
    with torch.set_grad_enabled(remat):
        got = tmodel(torch.from_numpy(x), torch.from_numpy(labels),
                     torch.from_numpy(ctx), torch.from_numpy(mask))
    if remat:
        got.square().mean().backward()
    assert got.dtype == torch.float32
    got = got.detach().numpy()
    jax_gap = rel_max_diff(want, f32)
    port_gap = rel_max_diff(got, want)
    assert jax_gap > 1e-3, jax_gap  # bf16 really ran
    assert port_gap <= 0.5 * jax_gap, (port_gap, jax_gap)


def test_bf16_dsm_loss_matches_jax_bf16(jax_refs):
    """The train-mode DSM loss (dropout 0, injected t and z, a 64-token
    caption, so every attention takes the kernel route) of four batches:
    the largest |port bf16 - JAX bf16| over the batches within half of the
    largest |JAX bf16 - JAX f32|. Measured: 1.95e-5 and 6.85e-5 of the
    loss. (One batch alone is no measure: its bf16 loss may land within
    5e-6 of the f32 one by chance.)"""
    cfg = load_config(tiny_config_dict(**BF16))
    tmodel = port_model(jax_refs["params"], **BF16)
    tsde, _ = get_sde(cfg)
    tloss = get_sde_loss_fn(tsde, tmodel, train=True, condition=("length",))
    got = []
    with torch.no_grad():
        for seed in LOSS_SEEDS:
            batch, t, z = _batch(seed)
            got.append(tloss(
                None, {k: torch.from_numpy(v) for k, v in batch.items()},
                t=torch.from_numpy(t), z=torch.from_numpy(z)).item())
    lf, lb = jax_refs["loss_f32"], jax_refs["loss_bf16"]
    jax_gap = np.abs(lb - lf).max() / np.abs(lf).max()
    port_gap = np.abs(np.asarray(got) - lb).max() / np.abs(lf).max()
    assert port_gap <= 0.5 * jax_gap, (port_gap, jax_gap)
