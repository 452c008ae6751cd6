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


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one intra-op thread for the module's tests, restored after.
    The test runner puts several worker processes on the CPU's cores, and
    at these tiny sizes every worker's spinning thread pool slows all of
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    """A CUDA device, or a skip when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run with `pytest -m gpu` on the "
                    "GPU machine")
    return torch.device("cuda")


def _atom(serial, name, res, chain, seq, xyz, altloc=" ", rec="ATOM  "):
    an = f" {name:<3s}" if len(name) < 4 else name
    return (f"{rec}{serial:5d} {an}{altloc}{res:>3s} {chain}{seq:4d}    "
            f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00"
            f"           {name[0]}")


HELIX_PDB_LENGTHS = (14, 6)  # chains A and B


def write_helix_pdb(path):
    """A two-chain helix PDB: residue 4 of chain A is MSE (non-standard),
    residue 8 of chain A has no C atom, residue 6 of chain A has an
    alternate location B (dropped by the reader), then a water and a
    truncated record. Returns `path`."""
    from text2protein_tpu_torch.data.helix_records import helix_backbone

    L_A, L_B = HELIX_PDB_LENGTHS
    rng = np.random.default_rng(11)
    lines, serial = [], 1
    for chain, length in (("A", L_A), ("B", L_B)):
        bb = helix_backbone(rng, length)
        for i in range(length):
            res = "MSE" if (chain, i) == ("A", 3) else "ALA"
            for j, name in enumerate(("N", "CA", "C")):
                if (chain, i, name) == ("A", 7, "C"):
                    continue  # a residue missing an atom
                lines.append(_atom(serial, name, res, chain, i + 1, bb[i, j]))
                serial += 1
                if (chain, i, name) == ("A", 5, "CA"):  # altloc B: dropped
                    lines.append(_atom(serial, name, res, chain, i + 1,
                                       bb[i, j] + 5.0, altloc="B"))
                    serial += 1
    lines.append(_atom(serial, "O", "HOH", "A", 100, (0.0, 0.0, 0.0),
                       rec="HETATM"))
    lines.append("ATOM  99999  CA  ALA A  99       1.0")  # truncated
    lines.append("END")
    path.write_text("\n".join(lines) + "\n")
    return path
