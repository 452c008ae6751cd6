"""The port on the card: each CUDA kernel against its plain PyTorch version,
and the model and sampler on the GPU against the same code on the CPU.

Every test takes the `cuda` fixture and skips without a card. This file
imports no JAX, so on the GPU machine (which has none) it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.diffusion import sampling as tsampling
from text2protein_tpu_torch.diffusion import sde as tsde
from text2protein_tpu_torch.models.unet import build_model, init_random_weights
from text2protein_tpu_torch.ops import attention as tattn
from text2protein_tpu_torch.ops import flash as tflash

from torch_port_helpers import (  # noqa: F401  (cuda is a fixture)
    C,
    CONTEXT_DIM,
    N,
    cuda,
    rel_max_diff,
    tiny_config_dict,
)

# (H, Tq, Tk, D, masked) of the L=128 serving path, then ragged tiles and
# the extremes of D that `supports` takes
SHAPES = [
    (1, 256, 256, 256, False),
    (8, 256, 256, 32, False),
    (8, 256, 64, 32, True),
    (1, 16, 16, 256, False),
    (8, 16, 16, 32, False),
    (8, 16, 64, 32, True),
    (2, 24, 40, 8, True),
    (1, 64, 72, 1024, False),
] + [
    # the reference configurations: test_config.yml's AttnBlock (D=512)
    # and transformer (8 heads of 64) at 32x32, 16x16 and 8x8, its cross-
    # attention over caption buckets of 64-512 keys; test_config_large's
    # 8x8 level (D=1024, heads of 128); the caption configs' cross-
    # attention at 16x16 and 4x4 (heads of 32) over 128-512 keys
    (1, 1024, 1024, 512, False),
    (8, 1024, 1024, 64, False),
    (8, 1024, 512, 64, True),
    (1, 256, 256, 512, False),
    (8, 256, 192, 64, True),
    (8, 64, 320, 64, True),
    (1, 64, 64, 1024, False),
    (8, 64, 64, 128, False),
    (8, 64, 448, 128, True),
    (8, 256, 384, 32, True),
    (8, 16, 512, 32, True),
]


@pytest.fixture(autouse=True)
def _full_f32():
    """Full f32 on the card: cuDNN convolutions run in TF32 by default."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _inputs(device, b, h, tq, tk, d, masked, seed=5):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(
        rng.standard_normal((b, h, t, d)).astype(np.float32)).to(device)
        for t in (tq, tk, tk))
    mask = None
    if masked:
        lengths = torch.from_numpy(rng.integers(1, tk + 1, size=b))
        mask = (torch.arange(tk)[None, :] < lengths[:, None]).to(device)
    return q, k, v, mask


@pytest.mark.gpu
@pytest.mark.parametrize("h,tq,tk,d,masked", SHAPES)
def test_flash_kernel_matches_plain_version(cuda, h, tq, tk, d, masked):
    """f32 on both sides, summed in another order: atol/rtol 1e-4."""
    q, k, v, mask = _inputs(cuda, 4, h, tq, tk, d, masked)
    before = tflash.flash_attention_fwd.launches
    got_o, got_l = tflash.flash_attention_fwd(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    assert tflash.flash_attention_fwd.launches == before + 1
    want_o, want_l = tflash.flash_attention_fwd_reference(q, k, v,
                                                          kv_mask=mask)
    torch.testing.assert_close(got_o, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_l, want_l, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_flash_kernel_fully_masked_row_gives_zero(cuda):
    q, k, v, _ = _inputs(cuda, 2, 8, 16, 64, 32, False)
    mask = torch.ones((2, 64), dtype=torch.bool, device=cuda)
    mask[1] = False
    out, lse = tflash.flash_attention_fwd(q, k, v, kv_mask=mask)
    assert torch.all(out[1] == 0)
    assert torch.isfinite(out).all()
    want_o, want_l = tflash.flash_attention_fwd_reference(q, k, v,
                                                          kv_mask=mask)
    torch.testing.assert_close(out, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, want_l, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_flash_wrapper_checks_its_inputs(cuda):
    q = torch.zeros((1, 1, 16, 32), device=cuda)
    with pytest.raises(TypeError):
        tflash.flash_attention_fwd(q.double(), q.double(), q.double())
    t = torch.zeros((1, 16, 2, 32), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention_fwd(t, t, t)
    with pytest.raises(ValueError):
        tflash.flash_attention_fwd(q, q.cpu(), q)
    # a call that needs a gradient goes through the autograd Function, and
    # the backward wrapper checks its inputs as the forward's does
    w = torch.zeros((1, 1, 16, 32), device=cuda, requires_grad=True)
    assert tattn.dot_product_attention(w, w, w).grad_fn is not None
    x = torch.zeros((1, 1, 64, 32), device=cuda)
    lse = torch.zeros((1, 64, 1), device=cuda)
    mask16 = torch.ones((1, 16), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="backward"):  # masked, Tk % 64 != 0
        tflash.flash_attention_bwd(x, x[:, :, :16], x[:, :, :16], x, lse, x,
                                   kv_mask=mask16)
    with pytest.raises(TypeError):  # the kernels read the mask as bytes
        tflash.flash_attention_fwd(x, x, x, kv_mask=torch.ones(
            (1, 64), device=cuda))
    with pytest.raises(ValueError, match="aligned"):
        y = torch.zeros(1 * 1 * 64 * 32 + 1, device=cuda)[1:]
        y = y.view(1, 1, 64, 32)
        tflash.flash_attention_fwd(y, y, y)
    with pytest.raises(TypeError):
        tflash.flash_attention_bwd(x, x, x, x, lse.double(), x)
    with pytest.raises(ValueError, match="lse"):
        tflash.flash_attention_bwd(x, x, x, x, lse[:, :8], x)


# (H, Tq, Tk, D, masked) that `supports_bwd` takes: the L=128 training
# path's kernel route, the N=256 widths, ragged tiles and the extremes of D
BWD_SHAPES = [
    (1, 256, 256, 256, False),
    (8, 256, 256, 32, False),
    (8, 256, 64, 32, True),
    (8, 16, 64, 32, True),
    (4, 64, 64, 64, True),
    (1, 256, 256, 512, False),
    (1, 24, 128, 8, True),
    (1, 64, 64, 1024, False),
    (2, 40, 128, 136, True),
] + SHAPES[-11:]  # the reference configurations' shapes


def _bwd_case(cuda, b, h, tq, tk, d, masked, dead_row=False):
    q, k, v, mask = _inputs(cuda, b, h, tq, tk, d, masked or dead_row)
    if dead_row:
        mask[-1] = False
    out, lse = tflash.flash_attention_fwd_reference(q, k, v, kv_mask=mask)
    gen = torch.Generator(device=cuda).manual_seed(7)
    g = torch.randn(out.shape, device=cuda, generator=gen)
    return q, k, v, out, lse, g, mask


@pytest.mark.gpu
@pytest.mark.parametrize("h,tq,tk,d,masked", BWD_SHAPES)
def test_flash_bwd_kernel_matches_plain_version(cuda, h, tq, tk, d, masked):
    """f32 on both sides, sums over up to 256 terms in another order:
    atol/rtol 1e-4, on gradients of magnitude up to ~100."""
    args = _bwd_case(cuda, 4, h, tq, tk, d, masked)
    before = tflash.flash_attention_bwd.launches
    got = tflash.flash_attention_bwd(*args[:6], kv_mask=args[6])
    torch.cuda.synchronize()
    assert tflash.flash_attention_bwd.launches == before + 1
    want = tflash.flash_attention_bwd_reference(*args[:6], kv_mask=args[6])
    for x, w in zip(got, want):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, w, atol=1e-4, rtol=1e-4)


# The f32 TF32 wgmma route (D <= 512) at the widths and lengths of the
# paths: each D of {32, 64, 256, 512} meets six (Tq, Tk) pairs that take
# every Tq of {16, 64, 128, 256, 1024} and every Tk of {16, 64, 192, 320,
# 512, 1024}; every other pair is a masked call with a fully masked batch
# row (the backward where `supports_bwd_cuda` takes it: Tk % 64 == 0)
TF32_TQ = (16, 64, 128, 256, 1024)
TF32_TK = (16, 64, 192, 320, 512, 1024)
TF32_SHAPES = [
    (8 if d <= 64 else 1, TF32_TQ[(i + o) % len(TF32_TQ)], tk, d, i % 2 == 1)
    for o, d in enumerate((32, 64, 256, 512))
    for i, tk in enumerate(TF32_TK)]


@pytest.mark.gpu
@pytest.mark.parametrize("h,tq,tk,d,masked", TF32_SHAPES)
def test_tf32_route_matches_plain_versions(cuda, h, tq, tk, d, masked):
    """Forward and backward on the TF32 wgmma kernels against their plain
    versions: the forward at atol/rtol 1e-4, the backward within 1e-4 of
    the gradient's scale (chip_smoke.py's bar: a dead row's gradients reach
    ~100); a fully masked row gives 0."""
    q, k, v, mask = _inputs(cuda, 2, h, tq, tk, d, masked)
    if masked:
        mask[-1] = False
    assert tflash.launch_plan("fwd", 2, h, tq, tk, d)["wgmma"] == 1
    got_o, got_l = tflash.flash_attention_fwd(q, k, v, kv_mask=mask)
    want_o, want_l = tflash.flash_attention_fwd_reference(q, k, v,
                                                          kv_mask=mask)
    torch.testing.assert_close(got_o, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_l, want_l, atol=1e-4, rtol=1e-4)
    if masked:
        assert torch.all(got_o[-1] == 0)
    if not tflash.supports_bwd_cuda(q, k, v, masked):
        assert masked and not tflash.supports_bwd(q, k, v)
        return
    plan = tflash.launch_plan("bwd", 2, h, tq, tk, d)
    assert plan["dq_wgmma"] == plan["dkdv_wgmma"] == 1
    g = torch.randn(q.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(9))
    got = tflash.flash_attention_bwd(q, k, v, want_o, want_l, g,
                                     kv_mask=mask)
    want = tflash.flash_attention_bwd_reference(q, k, v, want_o, want_l, g,
                                                kv_mask=mask)
    scale = max(1.0, max(w.abs().max().item() for w in want))
    for x, w in zip(got, want):
        assert torch.isfinite(x).all()
        assert (x - w).abs().max().item() <= 1e-4 * scale


@pytest.mark.gpu
def test_f32_launch_plan_reports_the_route(cuda):
    """The f32 plans name the route: wgmma is 1 at every D <= 512 (the
    forward, dq and dkdv) and 0 at D = 1024 (the mma.sync kernels) and at
    the mid block's AttnBlock (Tq = Tk = 16 at D = 256, the route's one
    exception); the backward's D = 256 and D = 512 run as clusters of
    D / 128 blocks, each block holding its 128 columns of the resident
    operands; the D = 512 forward runs two warpgroups a block and two
    z-chunks of 256 columns."""
    keys = set(tflash._PLAN_KEYS)
    for d in (32, 64, 128, 256, 512):
        fwd = tflash.launch_plan("fwd", 4, 1, 256, 256, d)
        assert set(fwd) == keys
        assert fwd["wgmma"] == 1 and fwd["cluster"] == 1
        assert fwd["narrow"] == (d <= 64)
        bwd = tflash.launch_plan("bwd", 2, 1, 256, 256, d)
        assert set(bwd) == {f"{k}_{n}" for k in ("dq", "dkdv") for n in keys}
        assert bwd["dq_wgmma"] == bwd["dkdv_wgmma"] == 1
        cluster = d // 128 if d > 128 else 1
        assert bwd["dq_cluster"] == bwd["dkdv_cluster"] == cluster
        assert bwd["dq_per_sm"] >= 1 and bwd["dkdv_per_sm"] >= 1
        if cluster > 1:
            assert bwd["dq_max_clusters"] >= 1
    big = tflash.launch_plan("fwd", 4, 1, 1024, 1024, 512)
    assert big["threads"] == 256 and big["chunks"] == 2
    for kind in ("fwd", "bwd"):
        mid = tflash.launch_plan(kind, 16, 1, 16, 16, 256)
        assert all(v == 0 for k, v in mid.items() if k.endswith("wgmma"))
    assert tflash.launch_plan("fwd", 4, 8, 16, 16, 32)["wgmma"] == 1
    wide = tflash.launch_plan("fwd", 2, 1, 64, 72, 1024)
    assert wide["wgmma"] == 0
    wide_bwd = tflash.launch_plan("bwd", 2, 1, 64, 72, 1024)
    assert wide_bwd["dq_wgmma"] == wide_bwd["dkdv_wgmma"] == 0


@pytest.mark.gpu
def test_flash_bwd_kernel_fully_masked_row(cuda):
    """The dead row keeps the JAX kernel's numbers (P = 1 on every key)."""
    args = _bwd_case(cuda, 3, 8, 256, 64, 32, True, dead_row=True)
    got = tflash.flash_attention_bwd(*args[:6], kv_mask=args[6])
    want = tflash.flash_attention_bwd_reference(*args[:6], kv_mask=args[6])
    assert got[0][-1].abs().max() > 0.1
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("h,tq,tk,d,masked", [BWD_SHAPES[2],
                                             (8, 16, 16, 32, False)])
def test_attention_grad_on_gpu_matches_cpu(cuda, h, tq, tk, d, masked):
    """Autograd through `dot_product_attention` on the card (the kernel,
    at Tk = 16 too, which the CPU sends to the einsum fallback) against the
    CPU: atol/rtol 1e-4."""
    q, k, v, mask = _inputs(cuda, 2, h, tq, tk, d, masked)
    g = torch.randn_like(q)
    grads = []
    for dev in (cuda, "cpu"):
        xs = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        m = None if mask is None else mask.to(dev)
        out = tattn.dot_product_attention(*xs, kv_mask=m)
        grads.append(torch.autograd.grad(out, xs, g.to(dev)))
    for x, w in zip(*grads):
        torch.testing.assert_close(x.cpu(), w, atol=1e-4, rtol=1e-4)


# (H, Tq, Tk, D, masked, dead row): the tile edges of the 3xTF32 kernels
# (Tq and Tk off the 16-row block, the 8-column mma tile and the inner
# tiles; D over the column chunks) and a fully masked row in both kernels
EDGE_SHAPES = [
    (1, 17, 9, 8, True, True),
    (2, 33, 47, 32, False, False),
    (1, 40, 64, 64, True, True),
    (1, 31, 100, 256, False, False),
    (1, 24, 72, 512, True, False),
    (1, 9, 17, 1024, False, False),
    (3, 256, 64, 32, True, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("h,tq,tk,d,masked,dead", EDGE_SHAPES)
def test_kernels_at_tile_edges_match_plain_versions(cuda, h, tq, tk, d,
                                                    masked, dead):
    """Both kernels against their plain versions, f32: atol/rtol 1e-4. The
    unmasked ragged shapes take the backward kernel through
    `supports_bwd_cuda`; the masked ones are inside `supports_bwd` or are
    called on the forward alone."""
    q, k, v, mask = _inputs(cuda, 3, h, tq, tk, d, masked or dead)
    if dead:
        mask[-1] = False
    got_o, got_l = tflash.flash_attention_fwd(q, k, v, kv_mask=mask)
    want_o, want_l = tflash.flash_attention_fwd_reference(q, k, v,
                                                          kv_mask=mask)
    torch.testing.assert_close(got_o, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_l, want_l, atol=1e-4, rtol=1e-4)
    if dead:
        assert torch.all(got_o[-1] == 0)
    if not tflash.supports_bwd_cuda(q, k, v, mask is not None):
        assert tflash.supports(q, k, v) and mask is not None
        return
    gen = torch.Generator(device=cuda).manual_seed(3)
    g = torch.randn(q.shape, device=cuda, generator=gen)
    before = tflash.flash_attention_bwd.launches
    got = tflash.flash_attention_bwd(q, k, v, want_o, want_l, g,
                                     kv_mask=mask)
    torch.cuda.synchronize()
    assert tflash.flash_attention_bwd.launches == before + 1
    want = tflash.flash_attention_bwd_reference(q, k, v, want_o, want_l, g,
                                                kv_mask=mask)
    for x, w in zip(got, want):
        assert torch.isfinite(x).all()
        torch.testing.assert_close(x, w, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("h,d", [(1, 256), (8, 32)])
def test_unmasked_tk16_backward_takes_the_kernel(cuda, h, d):
    """The 4x4 mid-block shapes (Tq = Tk = 16, no mask), which the JAX rule
    sends to the einsum fallback, launch the backward kernel on the card and
    match autograd of the einsum path (`_xla_attention`) there:
    atol/rtol 1e-4."""
    q, k, v, _ = _inputs(cuda, 16, h, 16, 16, d, False)
    assert not tflash.supports_bwd(q, k, v)
    assert tflash.supports_bwd_cuda(q, k, v, False)
    g = torch.randn_like(q)
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    before = tflash.flash_attention_bwd.launches
    got = torch.autograd.grad(tattn.dot_product_attention(*xs), xs, g)
    torch.cuda.synchronize()
    assert tflash.flash_attention_bwd.launches == before + 1
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        tattn._xla_attention(*xs, d**-0.5), xs, g)
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_masked_shape_outside_supports_bwd_takes_the_fallback(cuda):
    """A masked call that `supports_bwd` refuses (Tk = 16) keeps the JAX
    route on the card: no backward launch, gradients of the einsum path
    (atol/rtol 1e-4)."""
    q, k, v, mask = _inputs(cuda, 4, 8, 16, 16, 32, True)
    assert not tflash.supports_bwd_cuda(q, k, v, True)
    g = torch.randn_like(q)
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    before = tflash.flash_attention_bwd.launches
    got = torch.autograd.grad(
        tattn.dot_product_attention(*xs, kv_mask=mask), xs, g)
    assert tflash.flash_attention_bwd.launches == before
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        tattn._xla_attention(*xs, 32**-0.5, kv_mask=mask), xs, g)
    for x, w in zip(got, want):
        torch.testing.assert_close(x, w, atol=1e-4, rtol=1e-4)


def _tiny_models(cuda):
    cfg = load_config(tiny_config_dict())
    cpu = init_random_weights(build_model(cfg, device="cpu"), 1)
    gpu = build_model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    return cpu, gpu


@pytest.mark.gpu
def test_unet_on_gpu_matches_cpu(cuda):
    """The tiny UNet through the kernel (GPU) and the plain version (CPU):
    relative max diff < 1e-4 (f32, other conv and reduction orders)."""
    cpu, gpu = _tiny_models(cuda)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((2, N, N, C)) * 5)
                         .astype(np.float32))
    labels = torch.tensor([0.0, 99.0])
    ctx = torch.from_numpy(rng.standard_normal((2, 8, CONTEXT_DIM))
                           .astype(np.float32))
    mask = torch.ones((2, 8), dtype=torch.bool)
    mask[1, 3:] = False
    before = tflash.flash_attention_fwd.launches
    with torch.inference_mode():
        want = cpu(x, labels, ctx, mask)
        got = gpu(x.to(cuda), labels.to(cuda), ctx.to(cuda), mask.to(cuda))
    assert tflash.flash_attention_fwd.launches - before == 18
    assert rel_max_diff(got.cpu().numpy(), want.numpy()) < 1e-4


@pytest.mark.gpu
def test_pc_trajectory_on_gpu_matches_cpu(cuda):
    """Eight PC steps of the tiny model with the same injected draws on
    both devices: relative max diff < 1e-3."""
    cpu, gpu = _tiny_models(cuda)
    shape = (2, N, N, C)
    rng = np.random.default_rng(1)
    draws = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(1 + 8 * 2)]
    ctx = torch.from_numpy(rng.standard_normal((2, 8, CONTEXT_DIM))
                           .astype(np.float32))
    mask = torch.ones((2, 8), dtype=torch.bool)
    lengths = torch.tensor([9, 16])
    pos = torch.arange(N)
    row = pos[None, :] < lengths[:, None]
    cond = row[:, :, None] & row[:, None, :]
    sde = tsde.VESDE(N=100, sigma_min=0.01, sigma_max=100.0)
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        it = iter(draws)
        sampler = tsampling.get_pc_sampler(sde, model, shape, num_steps=8)
        out, _ = sampler(condition={"length": cond.to(dev)},
                         context=ctx.to(dev), context_mask=mask.to(dev),
                         noise_fn=lambda s: torch.from_numpy(next(it)).to(dev))
        outs.append(out.cpu().numpy())
    assert np.isfinite(outs[1]).all()
    assert rel_max_diff(outs[1], outs[0]) < 1e-3


# (H, Tq, Tk, D) of the deployment config's cross-attention
# (configs/deploy_l128.yml: the caption padded to a 16-token bucket): the
# 16x16 level and the 4x4 mid block
DEPLOY_SHAPES = [(8, 256, 16, 32), (8, 16, 16, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("h,tq,tk,d", DEPLOY_SHAPES)
def test_flash_kernel_at_the_deploy_caption_bucket(cuda, h, tq, tk, d):
    """The f32 forward over a 16-key masked caption, one row fully masked
    (its output 0), at batch 4: atol/rtol 1e-4 against the plain
    version."""
    q, k, v, _ = _inputs(cuda, 4, h, tq, tk, d, False, seed=9)
    lengths = torch.tensor([0, 3, 9, 16], device=cuda)
    mask = torch.arange(tk, device=cuda)[None, :] < lengths[:, None]
    before = tflash.flash_attention_fwd.launches
    got_o, got_l = tflash.flash_attention_fwd(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    assert tflash.flash_attention_fwd.launches == before + 1
    assert torch.all(got_o[0] == 0)
    want_o, want_l = tflash.flash_attention_fwd_reference(q, k, v,
                                                          kv_mask=mask)
    torch.testing.assert_close(got_o, want_o, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_l, want_l, atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_hybrid_with_cfg_on_gpu_matches_cpu(cuda):
    """A short hybrid (2 Heun steps, 3 PC steps) under CFG 2.0 with the
    same injected draws on both devices: relative max diff < 1e-3, the
    bar of the PC trajectory test on the card."""
    from text2protein_tpu_torch.diffusion.ode import get_hybrid_sampler

    cpu, gpu = _tiny_models(cuda)
    shape = (2, N, N, C)
    rng = np.random.default_rng(2)
    draws = [rng.standard_normal(shape).astype(np.float32)
             for _ in range(1 + 3 * 2)]
    ctx = torch.from_numpy(rng.standard_normal((2, 8, CONTEXT_DIM))
                           .astype(np.float32))
    mask = torch.ones((2, 8), dtype=torch.bool)
    mask[1, 5:] = False
    sde = tsde.VESDE(N=100, sigma_min=0.01, sigma_max=100.0)
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        it = iter(draws)
        sampler = get_hybrid_sampler(sde, model, shape, ode_steps=2,
                                     pc_steps=3, cfg_scale=2.0)
        before = tflash.flash_attention_fwd.launches
        out, nfe = sampler(context=ctx.to(dev), context_mask=mask.to(dev),
                           noise_fn=lambda s: torch.from_numpy(
                               next(it)).to(dev))
        launched = tflash.flash_attention_fwd.launches - before
        assert nfe == (2 * 2 + 3 * 2) * 2
        assert launched == (0 if dev == "cpu" else 18 * nfe)  # 18 per eval
        outs.append(out.cpu().numpy())
    assert np.isfinite(outs[1]).all()
    assert rel_max_diff(outs[1], outs[0]) < 1e-3


@pytest.mark.gpu
def test_train_step_gradients_on_gpu_match_cpu(cuda):
    """One tiny train step (dropout 0, injected t and z, a 64-token caption
    so every attention backward takes the kernel) on the GPU and the CPU:
    loss within rtol 1e-5, each gradient within 1e-3 of its own max abs
    (floored at 1e-3 of the largest; key-bias gradients are 0 in exact
    arithmetic)."""
    from text2protein_tpu_torch.diffusion.losses import get_sde_loss_fn

    cpu, gpu = _tiny_models(cuda)
    cfg = load_config(tiny_config_dict())
    sde, _ = tsde.get_sde(cfg)
    rng = np.random.default_rng(3)
    lengths = torch.tensor([11, N])
    row = torch.arange(N)[None, :] < lengths[:, None]
    mask_pair = row[:, :, None] & row[:, None, :]
    coords = torch.from_numpy(rng.uniform(-1, 1, (2, N, N, C))
                              .astype(np.float32)) * mask_pair[..., None]
    ctx_mask = torch.ones((2, 64), dtype=torch.bool)
    ctx_mask[0, 20:] = False
    batch = {"coords_6d": coords, "mask_pair": mask_pair,
             "context": torch.from_numpy(rng.standard_normal(
                 (2, 64, CONTEXT_DIM)).astype(np.float32)),
             "context_mask": ctx_mask}
    t = torch.tensor([0.3, 0.8])
    z = torch.from_numpy(rng.standard_normal((2, N, N, C))
                         .astype(np.float32))
    out = []
    for model, dev in ((gpu, cuda), (cpu, "cpu")):
        loss_fn = get_sde_loss_fn(sde, model, train=True,
                                  condition=("length",))
        before = tflash.flash_attention_bwd.launches
        loss = loss_fn(None, {k: v.to(dev) for k, v in batch.items()},
                       t=t.to(dev), z=z.to(dev))
        loss.backward()
        out.append((loss.item(), tflash.flash_attention_bwd.launches - before,
                    {k: p.grad.cpu() for k, p in model.named_parameters()}))
    (gl, glaunch, gg), (cl, claunch, cg) = out
    assert glaunch == 18 and claunch == 0
    assert abs(gl - cl) <= 1e-5 * abs(cl)
    floor = 1e-3 * max(g.abs().max().item() for g in cg.values())
    for k, want in cg.items():
        diff = (gg[k] - want).abs().max().item()
        assert diff <= 1e-3 * max(want.abs().max().item(), floor), k


# ------------------------------------------------------------------ bf16

# (B, H, Tq, Tk, D, masked) of the N=256 model (configs/quality_n256.yml):
# AttnBlock H=1 D=512, self-attention H=8 d=64, cross-attention over the
# 16-token caption bucket, at 32x32, 16x16 and 8x8; then ragged tiles, D
# that is not a multiple of 16 (8, 24, 136) and the largest D; then the
# edges of the wgmma kernels: Tq and Tk off the 64-row tiles at D = 512
# (TMA's zero fill), D = 512 masked with a dead row, D = 520 (the mma.sync
# kernel above 512, D % 16 == 8), and one 64-row tile (B*H = 1)
BF16_SHAPES = [
    (2, 1, 1024, 1024, 512, False),
    (2, 8, 1024, 1024, 64, False),
    (2, 8, 1024, 16, 64, True),
    (2, 1, 256, 256, 512, False),
    (2, 8, 256, 16, 64, True),
    (2, 1, 64, 64, 512, False),
    (2, 8, 64, 64, 64, False),
    (2, 8, 64, 16, 64, True),
    (3, 2, 24, 40, 8, True),
    (2, 3, 17, 9, 24, True),
    (2, 3, 17, 9, 24, False),
    (2, 2, 40, 72, 136, True),
    (1, 1, 64, 72, 1024, False),
    (2, 1, 72, 130, 512, False),
    (2, 1, 128, 128, 512, True),
    (2, 1, 64, 64, 520, False),
    (1, 1, 64, 64, 512, False),
    (1, 1, 64, 64, 64, False),
    # configs/quality_ss_vp.yml's train step at L=128, batch 16: the
    # AttnBlock at D=256 (the backward's output boxes over grid z), the
    # transformer's 8 heads of 32 (32-column boxes), the caption's 16 keys,
    # the 4x4 mid block (Tq = 16 in a 64-row block)
    (16, 1, 256, 256, 256, False),
    (16, 8, 256, 256, 32, False),
    (16, 8, 256, 16, 32, True),
    (16, 1, 16, 16, 256, False),
    (16, 8, 16, 16, 32, False),
    (16, 8, 16, 16, 32, True),
    # test_config_large.yml in bf16 (bench.py's dtype): the 8x8 AttnBlock
    # at D=1024 (the mma.sync kernels) and the heads of 128, at batch 1
    # and 2; bench_l128.yml in bf16 at batch 16: the cross-attention over
    # the 64-key bucket at 16x16 and in the 4x4 mid block
    (1, 1, 64, 64, 1024, False),
    (1, 8, 64, 64, 128, False),
    (2, 8, 64, 128, 128, True),
    (16, 8, 256, 64, 32, True),
    (16, 8, 16, 64, 32, True),
    # every width's instantiation on the wgmma route, ragged Tq and Tk and
    # (masked) a dead row: D <= 32 on 32-column boxes; 64 < D <= 256, the
    # backward's output boxes split over grid z (one and two chunks of dQ,
    # up to four of dK and dV); D > 512 forward on a cluster of two blocks
    # splitting D (an uneven split at D = 576 and 1000)
    (2, 3, 72, 136, 32, True),
    (3, 2, 100, 70, 32, False),
    (2, 2, 100, 130, 96, True),
    (2, 2, 72, 136, 96, False),
    (2, 3, 130, 72, 128, False),
    (2, 2, 64, 128, 128, True),
    (2, 1, 72, 136, 192, False),
    (3, 1, 130, 200, 256, False),
    (2, 1, 72, 128, 256, True),
    (2, 1, 64, 64, 576, False),
    (1, 1, 72, 136, 1024, False),
    (2, 1, 64, 128, 1024, True),
    (2, 1, 130, 70, 1000, False),
]


def bf16_step(scale):
    """One bf16 rounding step (ulp) at the magnitude `scale`."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def _bf16_inputs(device, b, h, tq, tk, d, masked, seed=7, dead_row=False):
    q, k, v, mask = _inputs(device, b, h, tq, tk, d, masked, seed)
    if dead_row and masked:
        mask[-1] = False
    return q.bfloat16(), k.bfloat16(), v.bfloat16(), mask


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,tq,tk,d,masked", BF16_SHAPES)
def test_bf16_fwd_kernel_matches_plain_version(cuda, b, h, tq, tk, d,
                                               masked):
    """The bf16 forward kernel against its plain version (f32 math, one
    rounding of out to bf16) on the same bf16 inputs: out within one bf16
    rounding step of its scale, lse within 1e-5 of max(1, |lse|) on the
    live rows and equal (-1e30) on the fully masked one."""
    q, k, v, mask = _bf16_inputs(cuda, b, h, tq, tk, d, masked,
                                 dead_row=True)
    before = tflash.flash_attention_fwd.launches_bf16
    out, lse = tflash.flash_attention_fwd(q, k, v, d**-0.5, mask)
    torch.cuda.synchronize()
    assert tflash.flash_attention_fwd.launches_bf16 == before + 1
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref, ref_lse = tflash.flash_attention_fwd_reference(q, k, v, d**-0.5,
                                                        mask)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= bf16_step(ref.float().abs().max().item()), err
    live = ref_lse > -1e29  # a fully masked row's lse is -1e30 in both
    lerr = (lse - ref_lse)[live].abs().max().item()
    assert lerr <= 1e-5 * max(1.0, ref_lse[live].abs().max().item()), lerr
    assert torch.equal(lse[~live], ref_lse[~live])
    if masked:
        assert (out[-1] == 0).all()  # the fully masked batch row


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,tq,tk,d,masked", BF16_SHAPES)
def test_bf16_bwd_kernel_matches_plain_version(cuda, b, h, tq, tk, d,
                                               masked):
    """The bf16 backward kernel against its plain version on the same bf16
    residuals (a fully masked batch row where masked): dq, dk, dv each
    within one bf16 rounding step of its own scale. Masked shapes that
    `supports_bwd_cuda` refuses (the JAX rule: Tk % 64, Tq % 8; the
    16-token caption) are called with 64 keys and Tq rounded up to a
    multiple of 8 instead."""
    if masked and (tk % 64 or tq % 8):
        tk, tq = 64, -(-tq // 8) * 8
    q, k, v, mask = _bf16_inputs(cuda, b, h, tq, tk, d, masked,
                                 dead_row=True)
    assert tflash.supports_bwd_cuda(q, k, v, masked)
    g = torch.randn(q.shape, device=cuda).bfloat16()
    out, lse = tflash.flash_attention_fwd(q, k, v, d**-0.5, mask)
    before = tflash.flash_attention_bwd.launches_bf16
    got = tflash.flash_attention_bwd(q, k, v, out, lse, g, d**-0.5, mask)
    torch.cuda.synchronize()
    assert tflash.flash_attention_bwd.launches_bf16 == before + 1
    want = tflash.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                d**-0.5, mask)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.bfloat16
        assert torch.isfinite(x).all(), name
        err = (x.float() - w.float()).abs().max().item()
        assert err <= bf16_step(w.float().abs().max().item()), (name, err)


@pytest.mark.gpu
def test_bf16_launch_plan_reports_the_wgmma_design(cuda):
    """The bf16 plans name the route, warpgroups, column chunks, stages,
    tiles, box columns and cluster; at the N=256 AttnBlock 32x32 (64 row
    tiles at B=4) the forward splits O over two column chunks, each
    computing S, and at B=8 computes S once; the dq kernel computes S and
    dP once per 64-row tile, dkdv twice; the D <= 64 forward gives each of
    two warpgroups its own 64 rows and the backward runs one; D > 512 runs
    the forward on a cluster of two blocks and keeps the backward's
    mma.sync kernels."""
    keys = {"warpgroups", "chunks", "stages", "tile", "rows", "blocks",
            "smem", "per_sm", "threads", "wgmma", "box", "cluster"}
    fwd = tflash.launch_plan("fwd", 4, 1, 1024, 1024, 512, torch.bfloat16)
    assert set(fwd) == keys
    assert fwd["wgmma"] == 1 and fwd["warpgroups"] == 2
    assert fwd["rows"] == 64 and fwd["chunks"] == 2
    assert fwd["blocks"] == 2 * 4 * 1024 // 64
    fwd8 = tflash.launch_plan("fwd", 8, 1, 1024, 1024, 512, torch.bfloat16)
    assert fwd8["chunks"] == 1 and fwd8["blocks"] == 8 * 1024 // 64
    assert fwd["stages"] >= 2 and fwd["per_sm"] >= 1
    assert fwd["threads"] == 2 * 128
    bwd = tflash.launch_plan("bwd", 8, 1, 1024, 1024, 512, torch.bfloat16)
    assert set(bwd) == {f"{k}_{n}" for k in ("dq", "dkdv") for n in keys}
    assert bwd["dq_wgmma"] == bwd["dkdv_wgmma"] == 1
    assert bwd["dq_chunks"] == 1 and bwd["dkdv_chunks"] == 2
    assert bwd["dq_per_sm"] >= 1 and bwd["dkdv_per_sm"] >= 1
    narrow = tflash.launch_plan("fwd", 4, 8, 1024, 1024, 64, torch.bfloat16)
    assert narrow["wgmma"] == 1 and narrow["warpgroups"] == 2
    assert narrow["rows"] == 128 and narrow["chunks"] == 1
    assert narrow["blocks"] == 32 * 1024 // 128 and narrow["tile"] == 64
    # the 16-token caption: 32-key tiles
    cross = tflash.launch_plan("fwd", 4, 8, 1024, 16, 64, torch.bfloat16)
    assert cross["tile"] == 32 and cross["rows"] == 128
    narrow_bwd = tflash.launch_plan("bwd", 8, 8, 1024, 1024, 64,
                                    torch.bfloat16)
    assert narrow_bwd["dq_warpgroups"] == narrow_bwd["dkdv_warpgroups"] == 1
    wide = tflash.launch_plan("fwd", 1, 1, 64, 72, 1024, torch.bfloat16)
    assert wide["wgmma"] == 1 and wide["cluster"] == 2
    assert wide["blocks"] == 2
    wide_bwd = tflash.launch_plan("bwd", 2, 1, 64, 64, 1024, torch.bfloat16)
    assert wide_bwd["dq_wgmma"] == wide_bwd["dkdv_wgmma"] == 0
    # the f32 plans keep their keys
    assert "narrow" in tflash.launch_plan("fwd", 4, 1, 256, 256, 256)


# (D, forward: box columns, cluster, column chunks, least blocks an SM;
# backward: warpgroups, box columns, dq and dkdv column chunks, least dq and
# dkdv blocks an SM) of each width's instantiation, at B=16, H=1, T=256
# (the L=128 AttnBlock's shape: 64 row tiles, so the D-split forward's
# boxes go over two chunks)
BF16_WIDTHS = [
    (32, (32, 1, 1, 2), (1, 32, 1, 1, 2, 2)),
    (64, (64, 1, 1, 2), (1, 64, 1, 1, 2, 2)),
    (96, (64, 1, 1, 1), (1, 64, 1, 1, 1, 1)),
    (128, (64, 1, 1, 1), (1, 64, 1, 1, 1, 1)),
    (256, (64, 1, 2, 1), (1, 64, 2, 2, 1, 1)),
    (512, (64, 1, 2, 1), (2, 64, 1, 2, 1, 1)),
    (1024, (64, 2, 1, 1), None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("d,fwd,bwd", BF16_WIDTHS)
def test_bf16_launch_plan_per_width(cuda, d, fwd, bwd):
    """Each width's route (every bf16 forward on wgmma; the backward on
    wgmma up to D = 512), its box columns, cluster, warpgroups, column
    chunks and the blocks an SM holds."""
    f = tflash.launch_plan("fwd", 16, 1, 256, 256, d, torch.bfloat16)
    assert f["wgmma"] == 1
    assert (f["box"], f["cluster"], f["chunks"]) == fwd[:3]
    assert f["per_sm"] >= fwd[3]
    assert f["blocks"] == (16 * -(-256 // f["rows"]) * f["cluster"]
                           * f["chunks"])
    b = tflash.launch_plan("bwd", 16, 1, 256, 256, d, torch.bfloat16)
    if bwd is None:
        assert b["dq_wgmma"] == b["dkdv_wgmma"] == 0
        return
    nwg, box, qc, kvc, q_sm, kv_sm = bwd
    assert b["dq_wgmma"] == b["dkdv_wgmma"] == 1
    assert b["dq_warpgroups"] == b["dkdv_warpgroups"] == nwg
    assert b["dq_box"] == b["dkdv_box"] == box
    assert (b["dq_chunks"], b["dkdv_chunks"]) == (qc, kvc)
    assert b["dq_blocks"] == 16 * 4 * qc and b["dkdv_blocks"] == 16 * 4 * kvc
    assert b["dq_per_sm"] >= q_sm and b["dkdv_per_sm"] >= kv_sm


@pytest.mark.gpu
def test_bf16_wrappers_check_dtypes(cuda):
    """One dtype for q, k, v (and out, g), float32 for lse; float16 is not
    taken."""
    x = torch.zeros((1, 1, 64, 32), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        tflash.flash_attention_fwd(x, x.float(), x)
    with pytest.raises(TypeError):
        tflash.flash_attention_fwd(x.half(), x.half(), x.half())
    lse = torch.zeros((1, 64, 1), device=cuda)
    with pytest.raises(TypeError):
        tflash.flash_attention_bwd(x, x, x, x, lse.bfloat16(), x)
    with pytest.raises(TypeError):
        tflash.flash_attention_bwd(x, x, x, x.float(), lse, x)


def _tiny_bf16_models(cuda, **model):
    cfg = load_config(tiny_config_dict(dtype="bfloat16",
                                       norm_dtype="bfloat16", **model))
    cpu = init_random_weights(build_model(cfg, device="cpu"), 1)
    gpu = build_model(cfg, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    return cfg, cpu, gpu


@pytest.mark.gpu
def test_bf16_unet_on_gpu_matches_cpu(cuda):
    """The tiny bf16 UNet on the GPU (bf16 kernels, cuDNN/cuBLAS with f32
    accumulation) against the same weights on the CPU in bf16: within the
    CPU's own bf16-against-f32 difference (sums in other orders flip bf16
    roundings, and each flip spreads through the layers)."""
    cfg, cpu, gpu = _tiny_bf16_models(cuda)
    f32 = build_model(load_config(tiny_config_dict()), device="cpu")
    f32.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal((2, N, N, C)) * 5)
                         .astype(np.float32))
    labels = torch.tensor([3.0, 70.0])
    ctx = torch.from_numpy(rng.standard_normal((2, 8, CONTEXT_DIM))
                           .astype(np.float32))
    mask = torch.ones((2, 8), dtype=torch.bool)
    mask[0, 3:] = False
    before = tflash.flash_attention_fwd.launches_bf16
    with torch.inference_mode():
        got = gpu(x.to(cuda), labels.to(cuda), ctx.to(cuda),
                  mask.to(cuda)).cpu()
        want = cpu(x, labels, ctx, mask)
        ref32 = f32(x, labels, ctx, mask)
    assert tflash.flash_attention_fwd.launches_bf16 - before == 18
    assert torch.isfinite(got).all()
    assert rel_max_diff(got, want) <= rel_max_diff(want, ref32)


@pytest.mark.gpu
def test_bf16_remat_step_on_gpu_matches_no_remat(cuda):
    """A tiny bf16 train step (dropout 0.1 from the step's generator) with
    the residual and transformer blocks rematted against the same step
    without remat, on the card: every gradient within 1e-5 of its own scale
    (floored at 1e-3 of the largest). cuDNN is off: it chooses algorithms
    within the allocator's largest free block, which remat changes."""
    from text2protein_tpu_torch.diffusion.losses import get_sde_loss_fn
    from text2protein_tpu_torch.models.attention import SpatialTransformer

    cfg, _, gpu = _tiny_bf16_models(cuda, dropout=0.1, remat_resblocks=True)
    sde, _ = tsde.get_sde(cfg)
    rng = np.random.default_rng(5)
    row = torch.arange(N)[None, :] < torch.tensor([11, N])[:, None]
    mask_pair = row[:, :, None] & row[:, None, :]
    batch = {"coords_6d": torch.from_numpy(rng.uniform(
                 -1, 1, (2, N, N, C)).astype(np.float32))
             * mask_pair[..., None],
             "mask_pair": mask_pair,
             "context": torch.from_numpy(rng.standard_normal(
                 (2, 64, CONTEXT_DIM)).astype(np.float32)),
             "context_mask": torch.ones((2, 64), dtype=torch.bool)}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    out = []
    with torch.backends.cudnn.flags(enabled=False):
        for remat in (True, False):
            gpu.remat_resblocks = remat
            for m in gpu.modules():
                if isinstance(m, SpatialTransformer):
                    m.remat = remat
            loss_fn = get_sde_loss_fn(sde, gpu, train=True,
                                      condition=("length",))
            gpu.zero_grad(set_to_none=True)
            gen = torch.Generator(device=cuda).manual_seed(9)
            loss = loss_fn(None, batch, gen)
            loss.backward()
            out.append((loss.item(), {k: p.grad.cpu() for k, p in
                                      gpu.named_parameters()}))
    (l1, g1), (l0, g0) = out
    assert np.isfinite(l1) and l1 == l0
    floor = 1e-3 * max(g.abs().max().item() for g in g0.values())
    for k, want in g0.items():
        diff = (g1[k].float() - want.float()).abs().max().item()
        assert diff <= 1e-5 * max(want.abs().max().item(), floor), k


@pytest.mark.gpu
def test_c8_inpainting_batch_on_gpu_matches_cpu(cuda):
    """The SS + inpainting batch on the card: random inpainting masks from
    the same injected draws, and from a generator on the card, are exact
    masks of the right kind; the C=8 featurization on the card within 1e-5
    of the CPU's (f32 sums in another order), its SS and mask channels
    exactly."""
    from text2protein_tpu_torch.conditioning import random_mask_batch
    from text2protein_tpu_torch.data.featurize import featurize_batch
    from text2protein_tpu_torch.data.helix_records import (
        helix_bundle_backbone,
    )

    cfg = load_config({"data": {"max_res_num": 64},
                       "model": {"condition": ["length", "inpainting"]}})
    rng = np.random.default_rng(3)
    lengths = torch.tensor([0, 5, 40, 64])
    draws = {"prob": 0.1, "span": rng.uniform(size=4),
             "scores": rng.uniform(size=(4, 64)),
             "start": rng.uniform(size=4)}
    want = random_mask_batch(lengths, 64, cfg, draws=draws)
    got = random_mask_batch(lengths.to(cuda), 64, cfg, draws=draws)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    gen = torch.Generator(device=cuda).manual_seed(1)
    drawn = random_mask_batch(lengths.to(cuda), 64, cfg, generator=gen)
    assert drawn.shape == (4, 64, 64) and drawn.dtype == torch.bool

    bb = np.zeros((2, 64, 3, 3), np.float32)
    mask = np.zeros((2, 64), bool)
    for i, L in enumerate((40, 64)):
        bb[i, :L] = helix_bundle_backbone(rng, L)
        mask[i, :L] = True
    ss = (rng.uniform(size=(2, 64, 64, 3)) < 0.3).astype(np.uint8)
    args = [torch.from_numpy(a) for a in (bb, mask)]
    want, want_pair = featurize_batch(*args, 8,
                                      ss_block=torch.from_numpy(ss))
    got, pair = featurize_batch(*[a.to(cuda) for a in args], 8,
                                ss_block=torch.from_numpy(ss).to(cuda))
    assert torch.equal(pair.cpu(), want_pair)
    assert (got.cpu() - want).abs().max().item() <= 1e-5
    assert torch.equal(got[..., 4:].cpu(), want[..., 4:])


def _resident_config(steps_per_launch=3):
    return load_config(dict(
        tiny_config_dict(),
        training={"sde": "vesde", "batch_size": 2, "log_freq": 1,
                  "eval_freq": 100, "steps_per_launch": steps_per_launch,
                  "snapshot_freq_for_preemption": 100},
        data={"max_res_num": N, "num_channels": C,
              "featurize_on_device": True}))


@pytest.mark.gpu
def test_resident_context_table_on_gpu_gathers_the_cpu_rows(cuda, tmp_path):
    """The trainer's resident context table on the card: its bf16 rows,
    gathered by record index and cast to f32, equal the CPU table's."""
    from text2protein_tpu_torch.cli import train
    from text2protein_tpu_torch.data.dataset import ProteinProcessedDataset
    from text2protein_tpu_torch.data.helix_records import write_records
    from text2protein_tpu_torch.text.encoder import build_text_encoder

    write_records(tmp_path, 12, lengths=(9, N))
    cfg = _resident_config()
    ds = ProteinProcessedDataset(tmp_path)
    encoder = build_text_encoder(cfg)
    resident = train.resident_table(cfg, ds, encoder, cuda)
    table, mask, inv = train.build_context_table(ds, encoder)
    assert resident["table"].is_cuda and resident["table"].dtype == (
        torch.bfloat16)
    idx = torch.tensor([3, 0, 7, 11, 3])
    rows = resident["inv"][idx.to(cuda)]
    assert torch.equal(resident["table"][rows].float().cpu(),
                       table[inv[idx].long()].float())
    assert torch.equal(resident["mask"][rows].cpu(), mask[inv[idx].long()])


@pytest.mark.gpu
def test_trainer_on_gpu_takes_the_table_on_full_groups(cuda, tmp_path):
    """`cli/train` on the card with the resident table, K=3 and 4 steps:
    one full group takes the table, the tail step the f32 encode; finite
    losses, and the JAX trainer's metric tags in workdir/tb."""
    import json

    from text2protein_tpu_torch.cli import train
    from text2protein_tpu_torch.config import save_config
    from text2protein_tpu_torch.data.helix_records import write_records

    write_records(tmp_path / "rec", 12, lengths=(9, N))
    save_config(_resident_config(), tmp_path / "cfg.yml")
    res = train.main(["--config", str(tmp_path / "cfg.yml"), "--data",
                      str(tmp_path / "rec"), "--max_steps", "4",
                      "--workdir_root", str(tmp_path / "runs")])
    assert res["table_steps"] == 3 and res["context_table"]["unique"] == 5
    assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 4
    tags = {json.loads(x)["tag"] for x in (
        res["workdir"] / "tb" / "metrics.jsonl").read_text().splitlines()}
    assert tags == {"training_loss", "avg_training_loss", "avg_eval_loss"}


def _realize_problem(L=24, seed=3):
    """A helix bundle's GT maps and 5 starts 0.5 A off its backbone."""
    from text2protein_tpu_torch.data.featurize import featurize_structure
    from text2protein_tpu_torch.data.synthetic import helix_bundle_backbone
    from text2protein_tpu_torch.realize.restraints import inverse_scale

    bb = helix_bundle_backbone(L, seed=seed, device="cpu")
    c6d, _, _ = featurize_structure(bb, np.ones(L), ss_constraints=False)
    rng = np.random.default_rng(0)
    starts = (bb[None] + rng.standard_normal((5,) + bb.shape)
              * 0.5).astype(np.float32)
    return bb, inverse_scale(c6d, L), torch.from_numpy(starts)


@pytest.mark.gpu
def test_realize_energies_on_gpu_match_cpu(cuda):
    """Every energy term and its gradient on the card against the CPU:
    energies within 1e-5 relative (floored at 1), gradients within 1e-4 of
    their largest entry."""
    from text2protein_tpu_torch.realize import minimize as tm
    from text2protein_tpu_torch.realize import restraints as tr

    bb, npz, starts = _realize_problem()
    ref = torch.from_numpy(bb[:, 1].copy())

    def terms(dev):
        rst = tr.restraints_from_maps(npz, device=dev)
        return {
            "restraint": lambda b: tr.restraint_energy(
                b, rst, 24.0, {"dist": 3.0, "orient": 1.0}),
            "long_dist": lambda b: tr.long_dist_energy(b, rst),
            "ca_coordinate": lambda b: tr.ca_coordinate_energy(
                b, ref.to(dev)),
            "bonded": tr.bonded_energy,
            "rama_cartesian": tr.rama_energy_cartesian,
            "hbond": tr.hbond_energy,
            "clash": tr.clash_energy,
            "e_fold": lambda b: tm.e_fold(b, rst),
            "e_ideal": lambda b: tm.e_ideal(b, rst),
        }

    def value_and_grad(fn, x):
        x = x.clone().requires_grad_(True)
        e = fn(x)
        (g,) = torch.autograd.grad(e.sum(), x)
        return e.detach().cpu().double(), g.cpu().double()

    cpu, gpu = terms("cpu"), terms(cuda)
    for name in cpu:
        e_c, g_c = value_and_grad(cpu[name], starts)
        e_g, g_g = value_and_grad(gpu[name], starts.to(cuda))
        assert ((e_g - e_c).abs() <= 1e-5 * e_c.abs().clamp(min=1.0)).all()
        assert (g_g - g_c).abs().max() <= 1e-4 * g_c.abs().max(), name


@pytest.mark.gpu
def test_realize_lbfgs_on_gpu_matches_cpu(cuda):
    """The first 5 fold-stage L-BFGS iterations of 5 starts on the card
    and on the CPU: the same linesearch steps, iterates within 1e-3 A (f32
    sums in the card's order part the iterates further at each
    iteration)."""
    from text2protein_tpu_torch.realize import minimize as tm
    from text2protein_tpu_torch.realize import restraints as tr
    from text2protein_tpu_torch.realize.lbfgs import LBFGS

    _, npz, starts = _realize_problem()
    solvers = {}
    for dev in ("cpu", cuda):
        rst = tr.restraints_from_maps(npz, device=dev)
        solvers[str(dev)] = LBFGS(lambda b, r=rst: tm.e_fold(b, r),
                                  starts.to(dev))
    c, g = solvers["cpu"], solvers[str(cuda)]
    for i in range(5):
        c.step()
        g.step()
        np.testing.assert_array_equal(g.linesearch_steps[i],
                                      c.linesearch_steps[i])
        torch.testing.assert_close(g.x.cpu(), c.x, rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_sharded_train_steps_on_gpu_match_the_plain_steps(cuda):
    """2 train steps of the tiny model (dropout 0.1, random inpainting
    masks) on up to 2 ranks, one per card (FSDP2 over NCCL), against the
    plain steps on the same card: losses within 1e-5 relative, the
    parameters within 1e-5 of their scale (the zero-gradient key biases
    within 2 lr a step)."""
    import torch_dist_workers as W
    from text2protein_tpu_torch import use_full_f32
    from text2protein_tpu_torch.parallel.launch import spawn
    from text2protein_tpu_torch.training.steps import make_train_step

    use_full_f32()  # as every rank (TF32 off for matmuls and cuDNN)
    lr = 1e-4
    cfg = tiny_config_dict(dropout=0.1, condition=["length", "inpainting"])
    cfg["optim"] = {"warmup": 0, "lr": lr}
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        lengths = rng.integers(9, N + 1, 4).astype(np.int32)
        row = np.arange(N)[None, :] < lengths[:, None]
        batches.append({
            "coords_6d": rng.uniform(-1, 1, (4, N, N, C)).astype(np.float32),
            "mask_pair": row[:, :, None] & row[:, None, :],
            "ss_spans": np.full((4, 32, 2), -1, np.int32),
            "length": lengths,
            "context": rng.standard_normal((4, 8, CONTEXT_DIM))
            .astype(np.float32),
            "context_mask": np.ones((4, 8), bool)})
    c, state = W.build_state(cfg, device=cuda)
    sde, _ = tsde.get_sde(c)
    step = make_train_step(c, sde, state.model)
    want_losses = [float(step(state, W.tensors(b, cuda), 5))
                   for b in batches]
    want = W.host_state(state)
    world = min(torch.cuda.device_count(), 2)
    got = spawn(W.train_steps, world,
                args=(cfg, world, 1, batches, 5, "cuda"), device="cuda",
                timeout=300)[0]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    for k, w in want["params"].items():
        diff = np.abs(got["params"][k] - w).max()
        bar = (2 * lr * 2 if k.endswith("NIN_1.b")
               else 1e-5 * max(np.abs(w).max(), lr * 2))
        assert diff <= bar, (k, diff)


@pytest.mark.gpu
def test_dryrun_multichip_on_gpu(cuda):
    from text2protein_tpu_torch.graft_entry import dryrun_multichip

    n = min(torch.cuda.device_count(), 4)
    res = dryrun_multichip(n, device="cuda", timeout=300)
    assert res["step"] == 1 and np.isfinite(res["loss"])
    assert res["samples"].shape == (n, 16, 16, 5)
    assert np.isfinite(res["samples"]).all()


@pytest.mark.gpu
def test_entry_forward_on_gpu_matches_cpu(cuda):
    """graft_entry.entry(): the flagship forward on the card (kernels)
    against the same on the CPU (plain versions), 1e-4 relative."""
    from text2protein_tpu_torch import use_full_f32
    from text2protein_tpu_torch.graft_entry import entry

    use_full_f32()
    with torch.no_grad():
        fn, args = entry(device="cuda")
        got = fn(*args).cpu().numpy()
        fn, args = entry(device="cpu")
        want = fn(*args).numpy()
    assert got.shape == (2, 128, 128, 5)
    assert rel_max_diff(got, want) < 1e-4


# (B, H, Tq, Tk, D, masked) of the bench_l128 train step with the pair
# grid's rows split over 2 ranks stacked on the batch axis (batch 16 x 2):
# a rank's query rows against the gathered keys (self-attention) or the
# whole caption (cross-attention), at 16x16 and in the 4x4 mid block
SP_SHAPES = [
    (32, 1, 128, 256, 256, False),
    (32, 8, 128, 256, 32, False),
    (32, 8, 128, 64, 32, True),
    (32, 1, 8, 16, 256, False),
    (32, 8, 8, 16, 32, False),
    (32, 8, 8, 64, 32, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,tq,tk,d,masked", SP_SHAPES)
def test_f32_kernels_at_the_sequence_parallel_shapes(cuda, b, h, tq, tk, d,
                                                     masked):
    """Both f32 kernels at the sequence-parallel step's shapes (fewer query
    rows than keys, Tq = 8) against their plain versions: the forward
    within atol/rtol 1e-4, the backward (the kernel, as the gate admits)
    within 1e-4 of the gradients' scale."""
    q, k, v, mask = _inputs(cuda, b, h, tq, tk, d, masked)
    out, lse = tflash.flash_attention_fwd(q, k, v, kv_mask=mask)
    want_out, want_lse = tflash.flash_attention_fwd_reference(q, k, v,
                                                              kv_mask=mask)
    torch.testing.assert_close(out, want_out, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    assert tflash.supports_bwd_cuda(q, k, v, masked)
    g = torch.randn(out.shape, device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(7))
    before = tflash.flash_attention_bwd.launches
    got = tflash.flash_attention_bwd(q, k, v, out, lse, g, kv_mask=mask)
    torch.cuda.synchronize()
    assert tflash.flash_attention_bwd.launches == before + 1
    want = tflash.flash_attention_bwd_reference(q, k, v, out, lse, g,
                                                kv_mask=mask)
    scale = max(1.0, max(w.abs().max().item() for w in want))
    for x, w in zip(got, want):
        assert torch.isfinite(x).all()
        assert (x - w).abs().max().item() <= 1e-4 * scale


@pytest.mark.gpu
def test_stacked_sp_step_on_gpu_matches_the_plain_step(cuda):
    """One train step of the tiny model (dropout 0.1, random inpainting
    masks) on the card with the pair grid's rows split over a stacked group
    of 2, against the plain step on the card: the loss within 2e-4
    relative and every gradient within 5e-3 of its scale (the card's train
    bars; floored at 1e-3 of the largest)."""
    import torch_dist_workers as W
    from text2protein_tpu_torch.parallel.sequence import StackedRowGroup
    from text2protein_tpu_torch.training.steps import make_train_step

    cfg = tiny_config_dict(dropout=0.1, condition=["length", "inpainting"])
    cfg["optim"] = {"warmup": 0, "lr": 1e-4}
    rng = np.random.default_rng(0)
    lengths = rng.integers(9, N + 1, 4).astype(np.int32)
    row = np.arange(N)[None, :] < lengths[:, None]
    batch = W.tensors({
        "coords_6d": rng.uniform(-1, 1, (4, N, N, C)).astype(np.float32),
        "mask_pair": row[:, :, None] & row[:, None, :],
        "ss_spans": np.full((4, 32, 2), -1, np.int32),
        "length": lengths,
        "context": rng.standard_normal((4, 8, CONTEXT_DIM))
        .astype(np.float32),
        "context_mask": np.ones((4, 8), bool)}, cuda)
    res = []
    for group in (None, StackedRowGroup(2)):
        c, state = W.build_state(cfg, device=cuda)
        sde, _ = tsde.get_sde(c)
        step = make_train_step(c, sde, state.model, shard_grid=group or False)
        loss = float(step(state, batch if group is None
                          else group.shard_batch(batch), 5))
        res.append((loss, {k: p.grad for k, p in
                           state.model.named_parameters()}))
    (want_loss, want), (got_loss, got) = res
    assert abs(got_loss - want_loss) <= 2e-4 * abs(want_loss)
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    for k, w in want.items():
        diff = (got[k] - w).abs().max().item()
        assert diff <= 5e-3 * max(w.abs().max().item(), floor), (k, diff)
