"""Shared pieces of the tests that hold text2protein_tpu_torch to the JAX
package: the tiny model, random flax params carried across, and the fixture
that gives a CUDA device or skips.

Whether there is a card is decided inside the fixture, never at import time,
so every pytest-xdist worker collects the same tests.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# tiny-but-real architecture: 2 levels, attention live at res 8
N, C, NF = 16, 5, 32
CH_MULT = (1, 2)
NUM_RES_BLOCKS = 2
ATTN_RES = (8,)
N_HEADS = 4
CONTEXT_DIM = 64
NUM_SCALES = 100


def tiny_config_dict(**model):
    return {
        "training": {"sde": "vesde"},
        "data": {"max_res_num": N, "num_channels": C},
        "model": {
            "condition": ["length"],
            "nf": NF,
            "ch_mult": list(CH_MULT),
            "num_res_blocks": NUM_RES_BLOCKS,
            "attn_resolutions": list(ATTN_RES),
            "n_heads": N_HEADS,
            "context_dim": CONTEXT_DIM,
            "num_scales": NUM_SCALES,
            "dropout": 0.0,
            **model,
        },
        "text": {"encoder": "hash", "pad_to_bucket": 8},
    }


def random_flax_params(template, seed):
    """Every leaf random (proj_out included, which flax zero-initializes),
    scaled by 1/sqrt(fan_in) so activations stay O(1)."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(a):
        fan_in = max(1, int(np.prod(a.shape[:-1])))
        scale = fan_in**-0.5 if a.ndim > 1 else 0.1
        out = rng.standard_normal(a.shape) * scale
        return out.astype(np.float32)

    return jax.tree_util.tree_map(leaf, template)


def flax_template(jmodel, x, labels, ctx, ctx_mask):
    """The params tree of a flax model, by shape only (nothing computed)."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(labels), jnp.asarray(ctx),
                            jnp.asarray(ctx_mask))
    )["params"]
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def rel_max_diff(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture
def cuda():
    """A CUDA device, or a skip when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run with `pytest -m gpu` on the "
                    "GPU machine")
    return torch.device("cuda")
