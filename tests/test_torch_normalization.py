"""The port's normalization zoo (models/normalization.py, NCHW) against the
JAX package's modules (NHWC), with the JAX modules' own parameters copied
across by name: the same numpy inputs, within 2e-5 of the output's scale.
"""

import jax
import numpy as np
import pytest
import torch

from text2protein_tpu.models import normalization as jnorm
from text2protein_tpu_torch.models import normalization as tnorm

from torch_port_helpers import one_torch_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B, H, W, CH, N_CLS = 3, 6, 5, 8, 4


def _x(seed=0):
    return (np.random.RandomState(seed).randn(B, H, W, CH) * 2 + 0.5
            ).astype(np.float32)


def _run(jmod, tmod, x, y=None):
    """Init the JAX module (random non-trivial parameters), load its
    parameters into the port's module, return both outputs as NHWC."""
    args = (x,) if y is None else (x, y)
    variables = jmod.init(jax.random.PRNGKey(1), *args)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.random.RandomState(2).uniform(
            -0.3, 0.3, np.shape(a)).astype(np.float32),
        dict(variables.get("params", {})))
    want = np.asarray(jmod.apply({**variables, "params": params}, *args))
    sd = {{"scale": "weight"}.get(k, k): torch.from_numpy(np.array(v))
          for k, v in params.items()}
    tmod.load_state_dict(sd, strict=False)
    assert set(sd) <= set(dict(tmod.named_parameters()))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy())
    targs = (xt,) if y is None else (xt, torch.from_numpy(y).long())
    with torch.no_grad():
        got = np.moveaxis(tmod(*targs).numpy(), 1, -1)
    return got, want


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("name", ["InstanceNorm2dPlus", "VarianceNorm2d"])
def test_unconditional_norm_matches_jax(name, bias):
    got, want = _run(getattr(jnorm, name)(bias=bias),
                     getattr(tnorm, name)(CH, bias=bias), _x())
    _close(got, want)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("name", [
    "ConditionalInstanceNorm2dPlus", "ConditionalInstanceNorm2d",
    "ConditionalVarianceNorm2d", "ConditionalNoneNorm2d"])
def test_conditional_norm_matches_jax(name, bias):
    y = np.array([0, 3, 1], np.int32)
    got, want = _run(getattr(jnorm, name)(num_classes=N_CLS, bias=bias),
                     getattr(tnorm, name)(CH, N_CLS, bias=bias), _x(1), y)
    _close(got, want)


@pytest.mark.parametrize("name", ["groupnorm", "instancenorm",
                                  "instancenorm++", "variancenorm",
                                  "nonenorm", "batchnorm"])
def test_get_normalization_matches_jax(name):
    got, want = _run(jnorm.get_normalization(name)(CH),
                     tnorm.get_normalization(name)(CH), _x(2))
    _close(got, want)


def test_conditional_dispatch_matches_jax():
    y = np.array([2, 2, 0], np.int32)
    got, want = _run(
        jnorm.get_normalization("InstanceNorm++", True, N_CLS)(CH),
        tnorm.get_normalization("InstanceNorm++", True, N_CLS)(CH), _x(3), y)
    _close(got, want)
    for mod in (jnorm, tnorm):
        with pytest.raises(NotImplementedError):
            mod.get_normalization("groupnorm", True, N_CLS)
        with pytest.raises(ValueError):
            mod.get_normalization("layernorm")


def test_initial_parameters_follow_the_jax_initializers():
    """Offsets from 1 near 0, biases 0, class rows' scales near 1 and
    biases 0: the JAX modules' initial values in distribution."""
    m = tnorm.ConditionalInstanceNorm2dPlus(64, 10)
    e = m.embed.detach()
    assert e.shape == (10, 192)
    assert abs(float(e[:, :128].mean()) - 1.0) < 0.01
    assert 0.015 < float(e[:, :128].std()) < 0.025
    assert torch.equal(e[:, 128:], torch.zeros(10, 64))
    p = tnorm.InstanceNorm2dPlus(256)
    assert 0.015 < float(p.alpha.detach().std()) < 0.025
    assert torch.equal(p.beta.detach(), torch.zeros(256))
