"""Carry the JAX package's ScoreUNet params into the port's ScoreUNet.

`state_dict_from_flax_params(params, config)` takes the flax params as nested
dicts of arrays (numpy, or anything `np.asarray` takes) and returns a
reference-format state dict of torch tensors that `ScoreUNet.load_state_dict`
takes with strict=True. The mapping replays the UNet's construction loops; it
is this package's own copy of the layout in
text2protein_tpu/interop/torch_port.py, so the port needs nothing of the JAX
package at run time.

Layouts bridged:
  flax Dense kernel (in, out)        -> torch Linear weight (out, in)
  flax Conv kernel (kh, kw, in, out) -> torch Conv2d weight (out, in, kh, kw)
  flax Dense as a 1x1 conv           -> Conv2d weight (out, in, 1, 1)
  flax Dense as NIN                  -> W (in, out), b (out) as they are
  flax norm `scale`                  -> `weight`
"""

from __future__ import annotations

import numpy as np
import torch


def _linear(w):
    return np.asarray(w, np.float32).T


def _conv(w):
    return np.asarray(w, np.float32).transpose(3, 2, 0, 1)


def _conv1x1_dense(w):
    return np.asarray(w, np.float32).T[:, :, None, None]


def _copy(w):
    return np.asarray(w, np.float32)


# kind -> [(flax_leaf, torch_suffix, transform)]
_KINDS = {
    "linear": [("kernel", "weight", _linear), ("bias", "bias", _copy)],
    "linear_nobias": [("kernel", "weight", _linear)],
    "conv": [("kernel", "weight", _conv), ("bias", "bias", _copy)],
    "conv1x1_dense": [("kernel", "weight", _conv1x1_dense),
                      ("bias", "bias", _copy)],
    "nin": [("kernel", "W", _copy), ("bias", "b", _copy)],
    "norm": [("scale", "weight", _copy), ("bias", "bias", _copy)],
}


def build_param_mapping(num_channels, max_res_num, nf, ch_mult,
                        num_res_blocks, attn_resolutions):
    """(flax_path, torch_key_prefix, kind) for every module with parameters,
    in construction order (BigGAN resblocks, attention pairs at
    `attn_resolutions`)."""
    ch_mult = tuple(ch_mult)
    attn_resolutions = tuple(attn_resolutions)
    num_resolutions = len(ch_mult)
    all_res = [max_res_num // (2**i) for i in range(num_resolutions)]
    entries = []
    counters = {"res": 0, "attn": 0, "spat": 0}

    entries.append((("Dense_0",), "pre_blocks.0", "linear"))
    entries.append((("Dense_1",), "pre_blocks.1", "linear"))
    entries.append((("Conv_0",), "pre_conv", "conv"))
    entries.append((("GroupNormF32Stats_0",), "out.0", "norm"))
    entries.append((("Conv_1",), "out.2", "conv"))

    def resblock(tbase, has_conv2):
        f = f"ResnetBlockBigGAN_{counters['res']}"
        counters["res"] += 1
        entries.append(((f, "GroupNormF32Stats_0"), f"{tbase}.GroupNorm_0",
                        "norm"))
        entries.append(((f, "Conv_0"), f"{tbase}.Conv_0", "conv"))
        entries.append(((f, "Dense_0"), f"{tbase}.Dense_0", "linear"))
        entries.append(((f, "GroupNormF32Stats_1"), f"{tbase}.GroupNorm_1",
                        "norm"))
        entries.append(((f, "Conv_1"), f"{tbase}.Conv_1", "conv"))
        if has_conv2:
            entries.append(((f, "Conv_2"), f"{tbase}.Conv_2", "conv"))

    def attnblock(tbase):
        f = f"AttnBlock_{counters['attn']}"
        counters["attn"] += 1
        entries.append(((f, "GroupNormF32Stats_0"), f"{tbase}.GroupNorm_0",
                        "norm"))
        for k in range(4):
            entries.append(((f, f"Dense_{k}"), f"{tbase}.NIN_{k}", "nin"))

    def spatial(tbase):
        f = f"SpatialTransformer_{counters['spat']}"
        counters["spat"] += 1
        entries.append(((f, "norm"), f"{tbase}.norm", "norm"))
        entries.append(((f, "proj_in"), f"{tbase}.proj_in", "conv1x1_dense"))
        b = (f, "block_0")
        tb = f"{tbase}.transformer_blocks.0"
        for attn in ("attn1", "attn2"):
            for proj in ("to_q", "to_k", "to_v"):
                entries.append((b + (attn, proj), f"{tb}.{attn}.{proj}",
                                "linear_nobias"))
            entries.append((b + (attn, "to_out"), f"{tb}.{attn}.to_out.0",
                            "linear"))
        for norm in ("norm1", "norm2", "norm3"):
            entries.append((b + (norm,), f"{tb}.{norm}", "norm"))
        entries.append((b + ("ff", "GEGLU_0", "Dense_0"),
                        f"{tb}.ff.net.0.proj", "linear"))
        entries.append((b + ("ff", "Dense_0"), f"{tb}.ff.net.2", "linear"))
        entries.append(((f, "proj_out"), f"{tbase}.proj_out",
                        "conv1x1_dense"))

    ib = 0
    in_ch = nf
    for i_level in range(num_resolutions):
        for _ in range(num_res_blocks):
            out_ch = nf * ch_mult[i_level]
            resblock(f"input_blocks.{ib}.0", has_conv2=in_ch != out_ch)
            in_ch = out_ch
            if all_res[i_level] in attn_resolutions:
                attnblock(f"input_blocks.{ib}.1")
                spatial(f"input_blocks.{ib}.2")
            ib += 1
        if i_level != num_resolutions - 1:
            resblock(f"input_blocks.{ib}.0", has_conv2=True)  # down
            ib += 1

    resblock("mid_blocks.0", has_conv2=False)
    attnblock("mid_blocks.1")
    spatial("mid_blocks.2")
    resblock("mid_blocks.3", has_conv2=False)

    # up path: every resblock sees a skip-concatenated width, so each has
    # its 1x1 Conv_2
    ob = 0
    for i_level in reversed(range(num_resolutions)):
        for i_block in range(num_res_blocks + 1):
            j = 0
            resblock(f"out_blocks.{ob}.{j}", has_conv2=True)
            if all_res[i_level] in attn_resolutions:
                attnblock(f"out_blocks.{ob}.{j + 1}")
                spatial(f"out_blocks.{ob}.{j + 2}")
                j += 2
            if i_level != 0 and i_block == num_res_blocks:
                resblock(f"out_blocks.{ob}.{j + 1}", has_conv2=True)  # up
            ob += 1
    return entries


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def state_dict_from_flax_params(params, config) -> dict[str, torch.Tensor]:
    """Flax ScoreUNet params -> the port's ScoreUNet state dict.

    `config` gives the architecture (`data.num_channels`,
    `data.max_res_num`, `model.nf`, `ch_mult`, `num_res_blocks`,
    `attn_resolutions`). Every flax leaf must be used, or the result would
    be silently wrong: a leaf the mapping does not know raises."""
    m = config.model
    mapping = build_param_mapping(
        config.data.num_channels, config.data.max_res_num, m.nf, m.ch_mult,
        m.num_res_blocks, m.attn_resolutions)
    state = {}
    used = set()
    for flax_path, tkey, kind in mapping:
        node = params
        for part in flax_path:
            if part not in node:
                raise KeyError(f"flax params missing {'/'.join(flax_path)} "
                               f"(wanted for {tkey})")
            node = node[part]
        for leaf, suffix, transform in _KINDS[kind]:
            if leaf not in node:
                raise KeyError(f"{'/'.join(flax_path)} has no leaf {leaf}")
            state[f"{tkey}.{suffix}"] = torch.from_numpy(
                np.ascontiguousarray(transform(node[leaf])))
            used.add(flax_path + (leaf,))
    unused = sorted("/".join(p) for p in set(_leaf_paths(params)) - used)
    if unused:
        raise ValueError(f"flax leaves not covered by the mapping: "
                         f"{unused[:8]}{'...' if len(unused) > 8 else ''}")
    return state
