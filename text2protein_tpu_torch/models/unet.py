"""Score UNet (counterpart of text2protein_tpu/models/unet.py).

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

`dtype` bfloat16 (`model.dtype`) computes the network in bf16 with f32
parameters, f32 GroupNorm statistics and an f32 output head, rounding where
the JAX model rounds (`layers`); `norm_dtype` bfloat16 lets the GroupNorms
follow their input's dtype. `remat_resblocks` rematerializes each residual
block in the backward, as every SpatialTransformer does its transformer
blocks (the JAX model's `remat_attention`, which its build_model never turns
off); neither changes the state dict or the function.

`init_params` draws fresh weights from the JAX model's own initializers
(the trainer starts from them); `init_random_weights` fills every tensor
with non-zero draws for the parity checks, which need every block live.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .. import resolve_device
from ..config import check_ported_model
from ..diffusion.sde import get_sigmas
from . import layers
from ..parallel.sequence import check_grid
from .attention import CrossAttention, LayerNorm, SpatialTransformer
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
                 sigma_max=100.0, num_scales=2000, remat_resblocks=False,
                 dtype=torch.float32, norm_dtype=torch.float32,
                 init_scale=0.0):
        # init_scale only shapes the initializers (`init_params`): the last
        # conv of each residual block, the AttnBlock's output projection
        # and the head
        super().__init__()
        self.init_scale = init_scale
        self.num_channels = num_channels
        self.max_res_num = max_res_num
        self.nf = nf
        self.scale_by_sigma = scale_by_sigma
        self.dtype = dtype
        self.remat_resblocks = remat_resblocks
        act = layers.get_act(nonlinearity)
        dtypes = dict(dtype=dtype, norm_dtype=norm_dtype)
        num_resolutions = self.num_resolutions = len(ch_mult)
        all_res = [max_res_num // (2**i) for i in range(num_resolutions)]
        temb_dim = nf * 4

        def resblock(in_ch, out_ch=None, up=False, down=False):
            if resblock_type == "biggan":
                return layers.ResnetBlockBigGAN(
                    act, in_ch, out_ch, temb_dim, up=up, down=down,
                    dropout=dropout, skip_rescale=skip_rescale, **dtypes)
            return layers.ResnetBlockDDPM(
                act, in_ch, out_ch, temb_dim, dropout=dropout,
                skip_rescale=skip_rescale, **dtypes)

        def attn_pair(ch):
            return [
                layers.AttnBlock(ch, skip_rescale=skip_rescale, **dtypes),
                SpatialTransformer(ch, n_heads, ch // n_heads,
                                   dropout=dropout, context_dim=context_dim,
                                   **dtypes),
            ]

        self.pre_blocks = nn.ModuleList(
            [layers.Linear(nf, temb_dim, dtype=dtype),
             layers.Linear(temb_dim, temb_dim, dtype=dtype)])
        self.pre_conv = layers.conv3x3(num_channels, nf, dtype=dtype)

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

        # the head is float32 whatever `dtype`: an f32 GroupNorm on the
        # network's output, act, an f32 conv (the score is divided by sigmas
        # down to 0.01, which bf16 cannot resolve)
        self.out = nn.ModuleList(
            [layers.group_norm(ch), _Act(act),
             layers.conv3x3(ch, num_channels)])
        self.register_buffer(
            "sigmas",
            torch.from_numpy(get_sigmas(sigma_min, sigma_max, num_scales)),
            persistent=False,
        )

    def set_row_group(self, group):
        """Split the pair grid's rows over `group` (`parallel.sequence`), or
        hold whole grids again with None: each 3x3 convolution, GroupNorm
        and self-attention then exchanges what crosses a rank's rows, and
        the forward takes and returns this rank's rows (x (B, N / size, N,
        C)). Raises ValueError where the rows do not split evenly at every
        level (`parallel.sequence.check_grid`)."""
        if group is not None:
            check_grid(self.max_res_num, self.num_resolutions, group.size)
        for m in self.modules():
            if isinstance(m, (layers.Conv2d, layers.GroupNormF32Stats,
                              layers.AttnBlock, CrossAttention)):
                m.row_group = group

    def _run(self, blocks, h, temb, context, context_mask, generator):
        for m in blocks:
            if isinstance(m, SpatialTransformer):
                h = m(h, context, context_mask, generator)
            elif isinstance(m, layers.AttnBlock):
                h = m(h)
            elif self.remat_resblocks and torch.is_grad_enabled():
                h = layers.remat(m, h, temb, generator=generator)
            else:
                h = m(h, temb, generator)
        return h

    def forward(self, x, time_cond, context=None, context_mask=None,
                generator=None):
        """x (B, N, N, C), time_cond (B,) labels; `generator` feeds every
        dropout mask in train mode (`model.train()`) and is unused in eval
        mode."""
        if x.shape[-1] != self.num_channels:
            raise ValueError(f"expected NHWC input with "
                             f"C={self.num_channels}, got {tuple(x.shape)}")
        temb = layers.get_timestep_embedding(time_cond, self.nf)
        temb = self.pre_blocks[1](self.pre_blocks[0](temb))

        h = self.pre_conv(x.to(self.dtype).permute(0, 3, 1, 2))
        hs = [h]
        for blk in self.input_blocks:
            h = self._run(blk, h, temb, context, context_mask, generator)
            hs.append(h)
        h = self._run(self.mid_blocks, h, temb, context, context_mask,
                      generator)
        for blk in self.out_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            h = self._run(blk, h, temb, context, context_mask, generator)
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


def _fans(w: torch.Tensor, layout: str):
    """(fan_in, fan_out) as flax computes them for the kernel this tensor
    holds: a conv's receptive field counts in both. `layout` "oihw" (a
    conv, HWIO in flax), "oi" (a torch Linear, (in, out) in flax) or "io"
    (a NIN, the flax layout)."""
    if layout == "oihw":
        rf = w[0, 0].numel()
        return w.shape[1] * rf, w.shape[0] * rf
    if layout == "oi":
        return w.shape[1], w.shape[0]
    return w.shape[0], w.shape[1]


def init_rules(model: "ScoreUNet") -> dict:
    """{parameter name: (kind, bound)}: the distribution the JAX module
    declares for each parameter (text2protein_tpu/models/{layers,attention,
    unet}.py), with kind

    - "uniform" on [-bound, bound]: `default_init(scale)`, fan_avg uniform
      variance scaling (a scale of 0 becomes 1e-10), bound
      sqrt(3 scale / fan_avg): the time-embedding Denses, the stem, every
      conv and temb Dense of a residual block (its last conv at the
      model's `init_scale`), the AttnBlock's q/k/v NINs (0.1) and output
      NIN (`init_scale`), a DDPM block's NIN shortcut (0.1), the head conv
      (`init_scale`);
    - "truncated_normal", a normal truncated at two standard deviations,
      the bound: flax Dense's default lecun_normal (variance 1 / fan_in):
      proj_in and every projection of the transformer blocks;
    - "zeros" (every bias, proj_out's kernel, the norms' shifts) and
      "ones" (the norms' scales), bound None.
    The fans are flax's: a conv kernel counts its receptive field in both."""
    from .attention import (CrossAttention, FeedForward, GEGLU, LayerNorm,
                            SpatialTransformer)

    init_scale = model.init_scale
    rules = {}  # id(parameter) -> (kind, bound)

    def fan_avg(p, scale=1.0, layout="oihw"):
        scale = 1e-10 if scale == 0 else scale
        fan_in, fan_out = _fans(p, layout)
        rules[id(p)] = ("uniform",
                        math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2)))

    def lecun(p, layout):
        # flax: stddev sqrt(1 / fan_in) / 0.8796..., the std of a standard
        # normal truncated to [-2, 2]
        std = math.sqrt(1.0 / _fans(p, layout)[0]) / .87962566103423978
        rules[id(p)] = ("truncated_normal", 2.0 * std)

    for m in model.modules():
        if isinstance(m, (layers.GroupNormF32Stats, LayerNorm)):
            rules[id(m.weight)] = ("ones", None)
        elif isinstance(m, ScoreUNet):
            for lin in m.pre_blocks:
                fan_avg(lin.weight, layout="oi")
            fan_avg(m.pre_conv.weight)
            fan_avg(m.out[2].weight, init_scale)
        elif isinstance(m, (layers.ResnetBlockBigGAN, layers.ResnetBlockDDPM)):
            fan_avg(m.Conv_0.weight)
            if m.Dense_0 is not None:
                fan_avg(m.Dense_0.weight, layout="oi")
            fan_avg(m.Conv_1.weight, init_scale)
            if m.Conv_2 is not None:
                fan_avg(m.Conv_2.weight)
            if getattr(m, "NIN_0", None) is not None:
                fan_avg(m.NIN_0.W, 0.1, "io")
        elif isinstance(m, layers.AttnBlock):
            for nin in (m.NIN_0, m.NIN_1, m.NIN_2):
                fan_avg(nin.W, 0.1, "io")
            fan_avg(m.NIN_3.W, init_scale, "io")
        elif isinstance(m, SpatialTransformer):
            lecun(m.proj_in.weight, "oihw")
            rules[id(m.proj_out.weight)] = ("zeros", None)
        elif isinstance(m, CrossAttention):
            for lin in (m.to_q, m.to_k, m.to_v, m.to_out[0]):
                lecun(lin.weight, "oi")
        elif isinstance(m, GEGLU):
            lecun(m.proj.weight, "oi")
        elif isinstance(m, FeedForward):
            lecun(m.net[2].weight, "oi")
            if not isinstance(m.net[0], GEGLU):
                lecun(m.net[0][0].weight, "oi")
    out = {}
    for name, p in model.named_parameters():
        if id(p) in rules:
            out[name] = rules[id(p)]
        elif p.ndim == 1:  # a bias or a norm's shift
            out[name] = ("zeros", None)
        else:
            raise AssertionError(f"no initializer for {name}")
    return out


@torch.no_grad()
def init_params(model: "ScoreUNet", generator: torch.Generator) -> "ScoreUNet":
    """Draw every parameter from the distribution the JAX module declares
    (`init_rules`), from `generator`, a CPU generator: the same numbers on
    any device. The trainer starts from these."""
    rules = init_rules(model)
    for name, p in model.named_parameters():
        kind, bound = rules[name]
        if kind in ("zeros", "ones"):
            p.fill_(0.0 if kind == "zeros" else 1.0)
            continue
        if kind == "uniform":
            draw = (torch.rand(p.shape, generator=generator,
                               dtype=torch.float64) * 2 - 1) * bound
        else:
            draw = torch.nn.init.trunc_normal_(
                torch.empty(p.shape, dtype=torch.float64), std=1.0,
                a=-2.0, b=2.0, generator=generator) * (bound / 2)
        p.copy_(draw.to(p.dtype))
    return model


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_model(config, device=None) -> ScoreUNet:
    """Construct the score model named by `config.model.name`, in eval
    mode, on `device` (CUDA unless the caller asks for the CPU), with the
    config's `model.dtype`, `model.norm_dtype` and `model.remat_resblocks`.
    Raises NotImplementedError for a model setting not ported
    (`config.check_ported_model`)."""
    check_ported_model(config)
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
        remat_resblocks=bool(m.get("remat_resblocks", False)),
        dtype=_DTYPES[str(m.get("dtype", "float32"))],
        norm_dtype=_DTYPES[str(m.get("norm_dtype", "float32"))],
        init_scale=float(m.get("init_scale", 0.0)),
    )
    return model.to(device).eval()
