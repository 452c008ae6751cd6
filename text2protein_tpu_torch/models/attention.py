"""LDM-style cross-attention stack (counterpart of
text2protein_tpu/models/attention.py).

SpatialTransformer: GroupNorm -> 1x1 proj_in -> HW tokens -> one
BasicTransformerBlock (pre-LN self-attention, cross-attention over the
caption with its key-padding mask, GEGLU feed-forward) -> 1x1 proj_out +
residual. Both attentions go through the flash-attention forward.

With `dtype` bfloat16 every Dense runs in bf16 (`layers.Linear`), the
LayerNorms keep f32 outputs (`nn.LayerNorm(dtype=jnp.float32)`) and the
next Dense casts them; the transformer blocks are rematerialized in the
backward (`remat`, flax `nn.remat`), as the JAX model does by default.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import (Conv2d, Dropout, GroupNormF32Stats, Linear, gather_keys,
                     gelu_tanh, remat)


class LayerNorm(nn.Module):
    """flax LayerNorm: eps 1e-6 and the variance as E[x^2] - E[x]^2."""

    def __init__(self, dim, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x = x.to(torch.float32)
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class GEGLU(nn.Module):
    def __init__(self, dim_in, dim_out, dtype=torch.float32):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2, dtype=dtype)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * gelu_tanh(gate)  # flax nn.gelu is the tanh form


class GELU(nn.Module):
    """flax `nn.gelu` as a parameter-free module slot."""

    def forward(self, x):
        return gelu_tanh(x)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4, glu=True, dropout=0.0,
                 dtype=torch.float32):
        super().__init__()
        inner = int(dim * mult)
        first = (GEGLU(dim, inner, dtype=dtype) if glu
                 else nn.Sequential(Linear(dim, inner, dtype=dtype), GELU()))
        self.net = nn.Sequential(first, Dropout(dropout, rows_dim=1),
                                 Linear(inner, dim, dtype=dtype))

    def forward(self, x, generator=None):
        return self.net[2](self.net[1](self.net[0](x), generator))


class CrossAttention(nn.Module):
    """Multi-head attention; context=None -> self-attention. With a
    `row_group` (`parallel.sequence`) self-attention's queries are this
    rank's tokens and its keys and values are gathered from every rank's;
    cross-attention is local (the whole caption is on every rank)."""

    row_group = None

    def __init__(self, query_dim, context_dim=None, heads=8, dim_head=64,
                 dropout=0.0, dtype=torch.float32):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Linear(context_dim, inner, bias=False, dtype=dtype)
        self.to_v = Linear(context_dim, inner, bias=False, dtype=dtype)
        self.to_out = nn.Sequential(Linear(inner, query_dim, dtype=dtype),
                                    Dropout(dropout, rows_dim=1))

    def forward(self, x, context=None, context_mask=None, generator=None):
        b, n, _ = x.shape
        ctx = x if context is None else context
        tk = ctx.shape[1]

        def heads(t, length):
            return t.reshape(b, length, self.heads, self.dim_head).transpose(1, 2)

        q = heads(self.to_q(x), n)
        if context is None and self.row_group is not None:
            k, v = gather_keys(self.row_group, self.to_k(ctx),
                               self.to_v(ctx))
            tk = k.shape[1]
            k, v = heads(k, tk), heads(v, tk)
        else:
            k = heads(self.to_k(ctx), tk)
            v = heads(self.to_v(ctx), tk)
        out = dot_product_attention(q, k, v, scale=self.dim_head**-0.5,
                                    kv_mask=context_mask)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return self.to_out[1](self.to_out[0](out), generator)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, n_heads, d_head, context_dim=None, dropout=0.0,
                 gated_ff=True, dtype=torch.float32):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head, dropout,
                                    dtype=dtype)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head,
                                    dropout, dtype=dtype)
        self.ff = FeedForward(dim, glu=gated_ff, dropout=dropout, dtype=dtype)
        # LayerNorms stay float32 (the JAX block's nn.LayerNorm(dtype=f32))
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x, context=None, context_mask=None, generator=None):
        x = self.attn1(self.norm1(x), generator=generator) + x
        x = self.attn2(self.norm2(x), context=context,
                       context_mask=context_mask, generator=generator) + x
        return self.ff(self.norm3(x), generator) + x


class SpatialTransformer(nn.Module):
    """Transformer over the flattened HW token grid with text
    cross-attention. Its GroupNorm takes min(32, C) groups, unlike the
    resblocks' `_num_groups`. Input and output (B, C, H, W). Each block is
    rematerialized when a gradient is taken (`remat`: the JAX model's
    `remat_attention`, which its `build_model` never turns off)."""

    def __init__(self, in_ch, n_heads, d_head, depth=1, dropout=0.0,
                 context_dim=None, dtype=torch.float32,
                 norm_dtype=torch.float32):
        super().__init__()
        inner = n_heads * d_head
        self.remat = True
        self.norm = GroupNormF32Stats(
            min(32, in_ch), in_ch, eps=1e-6,
            follow_input_dtype=norm_dtype != torch.float32)
        # 1x1 convolutions hold the JAX Denses' weights (the reference
        # layout); in bf16 they round as a Dense does
        self.proj_in = Conv2d(in_ch, inner, 1, dtype=dtype)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head,
                                  context_dim=context_dim, dropout=dropout,
                                  dtype=dtype)
            for _ in range(depth)
        )
        self.proj_out = Conv2d(inner, in_ch, 1, dtype=dtype)

    def forward(self, x, context=None, context_mask=None, generator=None):
        b, c, h, w = x.shape
        x_in = x
        x = self.proj_in(self.norm(x))
        inner = x.shape[1]
        x = x.flatten(2).transpose(1, 2)  # (B, HW, inner), row-major
        for block in self.transformer_blocks:
            if self.remat and torch.is_grad_enabled():
                x = remat(block, x, context, context_mask,
                          generator=generator)
            else:
                x = block(x, context, context_mask, generator)
        x = x.transpose(1, 2).reshape(b, inner, h, w)
        x = self.proj_out(x)
        return x + x_in.to(x.dtype)
