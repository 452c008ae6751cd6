"""The port's random training-time inpainting masks
(`conditioning.random_mask_batch`) against the JAX package's, fed the
uniforms that the JAX function draws from its key: the key split into five
and the draws of text2protein_tpu/conditioning.py:`random_mask_batch`
reproduced here. Masks are compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2protein_tpu import conditioning as jcond
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu_torch import conditioning as tcond
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.training.steps import (
    MASK_STREAM,
    step_generator,
    with_inpainting_mask,
)

N = 32
LENGTHS = np.array([0, 1, 2, 3, 7, 20, 31, 32], np.int32)


def _cfgd(**inpainting):
    return {"data": {"max_res_num": N},
            "model": {"condition": ["length", "inpainting"],
                      "inpainting": inpainting}}


def _jax_draws(key, b, n):
    """The uniforms JAX's random_mask_batch draws from `key`."""
    _, k_choice, k_len, k_perm, k_start = jax.random.split(key, 5)
    scores = jax.vmap(lambda k: jax.random.uniform(k, (n,)))(
        jax.random.split(k_perm, b))
    return {"prob": np.array(jax.random.uniform(k_choice)),
            "span": np.array(jax.random.uniform(k_len, (b,))),
            "scores": np.array(scores),
            "start": np.array(jax.random.uniform(k_start, (b,)))}


def _both(cfgd, seed, lengths=LENGTHS):
    key = jax.random.PRNGKey(seed)
    want = jcond.random_mask_batch(key, jnp.asarray(lengths), N,
                                   j_load_config(cfgd))
    draws = _jax_draws(key, len(lengths), N)
    got = tcond.random_mask_batch(torch.from_numpy(lengths), N,
                                  load_config(cfgd), draws=draws)
    return got, np.asarray(want), draws


@pytest.mark.parametrize("branch,probs", [
    ("random", dict(random_mask_prob=1.0, contiguous_mask_prob=0.0)),
    ("contiguous", dict(random_mask_prob=0.0, contiguous_mask_prob=1.0)),
    ("free", dict(random_mask_prob=0.0, contiguous_mask_prob=0.0)),
])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_each_branch_matches_jax(branch, probs, seed):
    """Each branch forced by the config's probabilities, lengths 0 to N
    (a length-0 row, spans of 0 and 1): equal to JAX bit for bit; the
    pair mask is m_i | m_j."""
    got, want, _ = _both(_cfgd(mask_min_len=0.05, mask_max_len=0.95,
                               **probs), seed)
    assert got.dtype == torch.bool and got.shape == (len(LENGTHS), N, N)
    np.testing.assert_array_equal(got.numpy(), want)
    m = got.numpy().any(axis=1) & ~got.numpy().all(axis=1)
    if branch == "free":
        assert got.all()
    else:
        assert not got[0].any()  # the length-0 row masks nothing
        row = got.numpy()[:, :, :].diagonal(axis1=1, axis2=2)
        np.testing.assert_array_equal(
            got.numpy(), row[:, :, None] | row[:, None, :])
        assert m.any()


@pytest.mark.parametrize("seed", range(12))
def test_default_probabilities_match_jax(seed):
    """The yml's probabilities (0.33, 0.33) and span fractions: whichever
    branch the key picks, equal bit for bit; the random branch's rows have
    exactly `span` residues, all real."""
    cfgd = _cfgd()
    got, want, draws = _both(cfgd, seed)
    np.testing.assert_array_equal(got.numpy(), want)
    if draws["prob"] < np.float32(0.33):
        row = got.numpy().diagonal(axis1=1, axis2=2)
        lo = (np.float32(0.05) * LENGTHS.astype(np.float32)).astype(np.int32)
        hi = (np.float32(0.95) * LENGTHS.astype(np.float32)).astype(np.int32)
        span = lo + (draws["span"] * np.maximum(hi - lo, 1).astype(
            np.float32)).astype(np.int32)
        np.testing.assert_array_equal(row.sum(axis=1), span)
        assert not (row & (np.arange(N)[None, :] >= LENGTHS[:, None])).any()


@pytest.mark.parametrize("fracs", [(0.0, 0.0), (0.1, 0.1), (0.05, 0.06),
                                   (0.3, 0.7), (0.95, 1.0)])
def test_short_and_truncated_spans_match_jax(fracs):
    """Span fractions that truncate to 0, to equal lo and hi (max(hi - lo,
    1)), and to the whole chain, in the random and contiguous branches."""
    for probs, seed in ((dict(random_mask_prob=1.0), 3),
                        (dict(random_mask_prob=0.0,
                              contiguous_mask_prob=1.0), 4)):
        got, want, _ = _both(_cfgd(mask_min_len=fracs[0],
                                   mask_max_len=fracs[1], **probs), seed)
        np.testing.assert_array_equal(got.numpy(), want)


def test_no_inpainting_condition_gives_none():
    cfg = load_config({"model": {"condition": ["length"]}})
    assert tcond.random_mask_batch(torch.tensor([5]), 8, cfg,
                                   generator=torch.Generator()) is None


def test_generator_draws_in_the_documented_order():
    """Drawn from a generator, the mask is the one the same uniforms give
    when injected (choice, spans, scores, starts in that order)."""
    cfg = load_config(_cfgd(random_mask_prob=1.0))
    lengths = torch.from_numpy(LENGTHS)
    b = len(LENGTHS)
    gen = torch.Generator().manual_seed(9)
    draws = {"prob": torch.rand((), generator=gen),
             "span": torch.rand((b,), generator=gen),
             "scores": torch.rand((b, N), generator=gen),
             "start": torch.rand((b,), generator=gen)}
    got = tcond.random_mask_batch(lengths, N, cfg,
                                  generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(
        got.numpy(), tcond.random_mask_batch(lengths, N, cfg,
                                             draws=draws).numpy())


def test_the_step_draws_its_mask_from_its_own_stream():
    """with_inpainting_mask: the mask of step s is random_mask_batch from
    step_generator(seed, s, MASK_STREAM); another step gives another mask;
    a batch that has a mask keeps it."""
    cfg = load_config(_cfgd(random_mask_prob=1.0))
    batch = {"length": torch.from_numpy(LENGTHS)}
    got = with_inpainting_mask(cfg, batch, 7, 3)["mask_inpaint"]
    want = tcond.random_mask_batch(
        batch["length"], N, cfg,
        generator=step_generator(7, 3, "cpu", MASK_STREAM))
    assert torch.equal(got, want)
    assert not torch.equal(
        got, with_inpainting_mask(cfg, batch, 7, 4)["mask_inpaint"])
    kept = dict(batch, mask_inpaint=want)
    assert with_inpainting_mask(cfg, kept, 7, 4)["mask_inpaint"] is want


def test_condition_from_batch_draws_random_masks():
    """get_condition_from_batch without mask_info: the inpainting mask is
    random_mask_batch of the batch's lengths from the generator."""
    cfg = load_config(_cfgd(random_mask_prob=1.0))
    b = 3
    batch = {"coords_6d": np.zeros((b, 5, N, N), np.float32),
             "length": np.array([4, 20, 32], np.int32)}
    cond = tcond.get_condition_from_batch(
        cfg, batch, generator=torch.Generator().manual_seed(2))
    want = tcond.random_mask_batch(torch.from_numpy(batch["length"]), N, cfg,
                                   generator=torch.Generator().manual_seed(2))
    assert torch.equal(cond["inpainting"]["mask_inpaint"], want)
    assert cond["inpainting"]["coords_6d"].shape == (b, N, N, 5)
