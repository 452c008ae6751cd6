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
    w = torch.zeros((1, 1, 16, 32), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        tattn.dot_product_attention(w, w, w)


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
