"""The port's small leftovers against the JAX package on the CPU: each
SDE's prior_logp, the config's sigma ladder, and the per-channel plot of
samples (its images, array for array)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.diffusion.sde import get_sde as j_get_sde
from text2protein_tpu.models.utils import (
    get_sigmas_for_config as j_get_sigmas_for_config,
)
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.diffusion.sde import get_sde
from text2protein_tpu_torch.models.utils import get_sigmas_for_config

CFG = {"model": {"sigma_min": 0.02, "sigma_max": 80.0, "num_scales": 37,
                 "beta_min": 0.2, "beta_max": 15.0}}


@pytest.mark.parametrize("sde", ["vesde", "vpsde", "subvpsde"])
def test_prior_logp_matches_jax(sde):
    cfg = {**CFG, "training": {"sde": sde}}
    z = (np.random.RandomState(0).randn(3, 16, 16, 5) * 30).astype(
        np.float32)
    jsde, _ = j_get_sde(j_load_config(cfg))
    tsde, _ = get_sde(load_config(cfg))
    want = np.asarray(jsde.prior_logp(jnp.asarray(z)))
    got = tsde.prior_logp(torch.from_numpy(z)).numpy()
    assert got.shape == want.shape == (3,) and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_get_sigmas_for_config_matches_jax():
    want = np.asarray(j_get_sigmas_for_config(j_load_config(CFG)))
    got = get_sigmas_for_config(load_config(CFG))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(80.0) and len(got) == 37


def test_show_all_channels_matches_jax(tmp_path):
    """The same grid of images from a (C, N, N) map and an NHWC one (the
    port also takes tensors), and the same file written."""
    from text2protein_tpu.utils.plotting import show_all_channels as jshow
    from text2protein_tpu_torch.utils.plotting import show_all_channels

    rng = np.random.RandomState(1)
    samples = [rng.randn(5, 12, 12).astype(np.float32),
               rng.randn(12, 12, 5).astype(np.float32)]
    want = jshow(samples, path=tmp_path / "jax.png", nrows=2, ncols=5)
    got = show_all_channels([torch.from_numpy(s) for s in samples],
                            path=tmp_path / "port.png", nrows=2, ncols=5)

    def images(fig):
        return [np.asarray(im.get_array()) for ax in fig.axes
                for im in ax.get_images()]

    a, b = images(got), images(want)
    assert len(a) == len(b) == 10
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert (tmp_path / "port.png").stat().st_size > 0
    assert ((tmp_path / "port.png").read_bytes()
            == (tmp_path / "jax.png").read_bytes())
