"""LDM-style cross-attention stack (counterpart of
text2protein_tpu/models/attention.py).

SpatialTransformer: GroupNorm -> 1x1 proj_in -> HW tokens -> one
BasicTransformerBlock (pre-LN self-attention, cross-attention over the
caption with its key-padding mask, GEGLU feed-forward) -> 1x1 proj_out +
residual. Both attentions go through the flash-attention forward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import GroupNormF32Stats


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
    def __init__(self, dim_in, dim_out):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        x, gate = self.proj(x).chunk(2, dim=-1)
        return x * F.gelu(gate, approximate="tanh")  # flax nn.gelu is tanh


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4, glu=True, dropout=0.0):
        super().__init__()
        inner = int(dim * mult)
        first = (GEGLU(dim, inner) if glu
                 else nn.Sequential(nn.Linear(dim, inner),
                                    nn.GELU(approximate="tanh")))
        self.net = nn.Sequential(first, nn.Dropout(dropout),
                                 nn.Linear(inner, dim))

    def forward(self, x):
        return self.net(x)


class CrossAttention(nn.Module):
    """Multi-head attention; context=None -> self-attention."""

    def __init__(self, query_dim, context_dim=None, heads=8, dim_head=64,
                 dropout=0.0):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim),
                                    nn.Dropout(dropout))

    def forward(self, x, context=None, context_mask=None):
        b, n, _ = x.shape
        ctx = x if context is None else context
        tk = ctx.shape[1]

        def heads(t, length):
            return t.reshape(b, length, self.heads, self.dim_head).transpose(1, 2)

        q = heads(self.to_q(x), n)
        k = heads(self.to_k(ctx), tk)
        v = heads(self.to_v(ctx), tk)
        out = dot_product_attention(q, k, v, scale=self.dim_head**-0.5,
                                    kv_mask=context_mask)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return self.to_out(out)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, n_heads, d_head, context_dim=None, dropout=0.0,
                 gated_ff=True):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, n_heads, d_head, dropout)
        self.attn2 = CrossAttention(dim, context_dim, n_heads, d_head, dropout)
        self.ff = FeedForward(dim, glu=gated_ff, dropout=dropout)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x, context=None, context_mask=None):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context=context,
                       context_mask=context_mask) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """Transformer over the flattened HW token grid with text
    cross-attention. Its GroupNorm takes min(32, C) groups, unlike the
    resblocks' `_num_groups`. Input and output (B, C, H, W)."""

    def __init__(self, in_ch, n_heads, d_head, depth=1, dropout=0.0,
                 context_dim=None):
        super().__init__()
        inner = n_heads * d_head
        self.norm = GroupNormF32Stats(min(32, in_ch), in_ch, eps=1e-6)
        self.proj_in = nn.Conv2d(in_ch, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, n_heads, d_head,
                                  context_dim=context_dim, dropout=dropout)
            for _ in range(depth)
        )
        self.proj_out = nn.Conv2d(inner, in_ch, 1)

    def forward(self, x, context=None, context_mask=None):
        b, c, h, w = x.shape
        x_in = x
        x = self.proj_in(self.norm(x))
        inner = x.shape[1]
        x = x.flatten(2).transpose(1, 2)  # (B, HW, inner), row-major
        for block in self.transformer_blocks:
            x = block(x, context, context_mask)
        x = x.transpose(1, 2).reshape(b, inner, h, w)
        return self.proj_out(x) + x_in
