"""Score UNet (counterpart of text2protein_tpu/models/unet.py), eval path.

Same topology block for block: sinusoidal time embedding -> two Linears with
no act between; stem conv; down path of BigGAN resblocks with AttnBlock +
SpatialTransformer at `attn_resolutions` and down-resampling resblocks; mid
Res -> Attn -> SpatialTransformer -> Res; mirrored up path with skip
concatenation; GroupNorm -> act -> conv head; output divided by
sigmas[time_cond] when `scale_by_sigma`.

The public boundary is NHWC, as in the JAX package: x (B, N, N, C) in, the
score (B, N, N, C) out. Inside, the convolutions run in NCHW. Submodules are
named as the reference-format state dict (`pre_blocks`, `pre_conv`,
`input_blocks.{i}.{j}`, `mid_blocks`, `out_blocks.{i}.{j}`, `out`), so
`interop.from_jax` output and reference checkpoints load with strict=True.
"""

from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..diffusion.sde import get_sigmas
from . import layers
from .attention import LayerNorm, SpatialTransformer
from .registry import get_model, register_model


class _Act(nn.Module):
    """The head's activation, a parameter-free slot (`out.1`)."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


@register_model(name="ncsnpp")
class ScoreUNet(nn.Module):
    def __init__(self, num_channels, max_res_num, nf=128,
                 ch_mult=(1, 1, 2, 2, 2, 2), num_res_blocks=2,
                 attn_resolutions=(16,), dropout=0.1, n_heads=8,
                 context_dim=4096, skip_rescale=True, resblock_type="biggan",
                 nonlinearity="swish", scale_by_sigma=True, sigma_min=0.01,
                 sigma_max=100.0, num_scales=2000):
        # The JAX model's init_scale only shapes its initializers; weights
        # here come from a state dict or `init_random_weights`.
        super().__init__()
        self.num_channels = num_channels
        self.nf = nf
        self.scale_by_sigma = scale_by_sigma
        act = layers.get_act(nonlinearity)
        num_resolutions = len(ch_mult)
        all_res = [max_res_num // (2**i) for i in range(num_resolutions)]
        temb_dim = nf * 4

        def resblock(in_ch, out_ch=None, up=False, down=False):
            if resblock_type == "biggan":
                return layers.ResnetBlockBigGAN(
                    act, in_ch, out_ch, temb_dim, up=up, down=down,
                    dropout=dropout, skip_rescale=skip_rescale)
            return layers.ResnetBlockDDPM(
                act, in_ch, out_ch, temb_dim, dropout=dropout,
                skip_rescale=skip_rescale)

        def attn_pair(ch):
            return [
                layers.AttnBlock(ch, skip_rescale=skip_rescale),
                SpatialTransformer(ch, n_heads, ch // n_heads,
                                   dropout=dropout, context_dim=context_dim),
            ]

        self.pre_blocks = nn.ModuleList(
            [nn.Linear(nf, temb_dim), nn.Linear(temb_dim, temb_dim)])
        self.pre_conv = layers.conv3x3(num_channels, nf)

        ch = nf
        skip_ch = [ch]
        self.input_blocks = nn.ModuleList()
        for i_level in range(num_resolutions):
            for _ in range(num_res_blocks):
                out_ch = nf * ch_mult[i_level]
                blk = [resblock(ch, out_ch)]
                ch = out_ch
                if all_res[i_level] in attn_resolutions:
                    blk += attn_pair(ch)
                self.input_blocks.append(nn.ModuleList(blk))
                skip_ch.append(ch)
            if i_level != num_resolutions - 1:
                self.input_blocks.append(
                    nn.ModuleList([resblock(ch, down=True)]))
                skip_ch.append(ch)

        self.mid_blocks = nn.ModuleList(
            [resblock(ch)] + attn_pair(ch) + [resblock(ch)])

        self.out_blocks = nn.ModuleList()
        for i_level in reversed(range(num_resolutions)):
            for i_block in range(num_res_blocks + 1):
                out_ch = nf * ch_mult[i_level]
                blk = [resblock(ch + skip_ch.pop(), out_ch)]
                ch = out_ch
                if all_res[i_level] in attn_resolutions:
                    blk += attn_pair(ch)
                if i_level != 0 and i_block == num_res_blocks:
                    blk.append(resblock(ch, up=True))
                self.out_blocks.append(nn.ModuleList(blk))
        assert not skip_ch

        self.out = nn.ModuleList(
            [layers.group_norm(ch), _Act(act),
             layers.conv3x3(ch, num_channels)])
        self.register_buffer(
            "sigmas",
            torch.from_numpy(get_sigmas(sigma_min, sigma_max, num_scales)),
            persistent=False,
        )

    def _run(self, blocks, h, temb, context, context_mask):
        for m in blocks:
            if isinstance(m, SpatialTransformer):
                h = m(h, context, context_mask)
            elif isinstance(m, layers.AttnBlock):
                h = m(h)
            else:
                h = m(h, temb)
        return h

    def forward(self, x, time_cond, context=None, context_mask=None):
        if x.shape[-1] != self.num_channels:
            raise ValueError(f"expected NHWC input with "
                             f"C={self.num_channels}, got {tuple(x.shape)}")
        temb = layers.get_timestep_embedding(time_cond, self.nf)
        temb = self.pre_blocks[1](self.pre_blocks[0](temb))

        h = self.pre_conv(x.to(torch.float32).permute(0, 3, 1, 2))
        hs = [h]
        for blk in self.input_blocks:
            h = self._run(blk, h, temb, context, context_mask)
            hs.append(h)
        h = self._run(self.mid_blocks, h, temb, context, context_mask)
        for blk in self.out_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            h = self._run(blk, h, temb, context, context_mask)
        assert not hs

        h = self.out[2](self.out[1](self.out[0](h)))
        if self.scale_by_sigma:
            used = self.sigmas[time_cond.to(torch.int64)]
            h = h / used.reshape(-1, 1, 1, 1)
        return h.permute(0, 2, 3, 1)


@torch.no_grad()
def init_random_weights(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from a seeded CPU generator, the same numbers on
    any device: weights N(0, 1/fan_in), biases N(0, 0.02^2), norm scales
    1 + N(0, 0.1^2) and shifts N(0, 0.1^2). Nothing is zero, proj_out
    included, so no block of the network is silent."""
    gen = torch.Generator().manual_seed(seed)

    def normal(p, std, mean=0.0):
        p.copy_(torch.randn(p.shape, generator=gen) * std + mean)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            normal(m.weight, fan_in**-0.5)
            if m.bias is not None:
                normal(m.bias, 0.02)
        elif isinstance(m, layers.NIN):
            normal(m.W, m.W.shape[0] ** -0.5)
            normal(m.b, 0.02)
        elif isinstance(m, (layers.GroupNormF32Stats, LayerNorm)):
            normal(m.weight, 0.1, 1.0)
            normal(m.bias, 0.1)
    return model


def build_model(config, device=None) -> ScoreUNet:
    """Construct the score model named by `config.model.name`, in eval
    mode, on `device` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    m = config.model
    cls = get_model(m.get("name", "ncsnpp"))
    model = cls(
        num_channels=config.data.num_channels,
        max_res_num=config.data.max_res_num,
        nf=m.nf,
        ch_mult=tuple(m.ch_mult),
        num_res_blocks=m.num_res_blocks,
        attn_resolutions=tuple(m.attn_resolutions),
        dropout=m.dropout,
        n_heads=m.n_heads,
        context_dim=m.context_dim,
        skip_rescale=m.skip_rescale,
        resblock_type=m.resblock_type.lower(),
        nonlinearity=m.nonlinearity,
        scale_by_sigma=m.scale_by_sigma,
        sigma_min=m.sigma_min,
        sigma_max=m.sigma_max,
        num_scales=m.num_scales,
    )
    return model.to(device).eval()
