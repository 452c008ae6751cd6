"""The port's initializers (`models.unet.init_params`, `init_rules`) against
the JAX model's own (`ScoreUNet.init`), on the tiny UNet of
torch_port_helpers, and the trainer's start from them.

A draw cannot be compared number by number (threefry against torch's
generators), so each parameter is held to the distribution: the same key
set, the same exactly-zero tensors, ones where JAX has ones, every entry
of both packages inside the port's bound, and each tensor's variance,
in both packages, within a statistical tolerance of the variance the
port's rule implies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu_torch.cli import train as ttrain
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.data.helix_records import write_records
from text2protein_tpu_torch.interop.from_jax import (
    state_dict_from_flax_params,
)
from text2protein_tpu_torch.models.unet import (
    build_model,
    init_params,
    init_rules,
)

from torch_port_helpers import C, CONTEXT_DIM, N, tiny_config_dict

# the variance of a standard normal truncated to [-2, 2]
TRUNC_VAR = 0.7737413


def _jax_params(cfgd, seed):
    jmodel = j_build_model(j_load_config(cfgd))
    params = jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, N, N, C)), jnp.zeros((1,)),
        jnp.zeros((1, 8, CONTEXT_DIM)), jnp.ones((1, 8), bool))["params"]
    sd = state_dict_from_flax_params(
        jax.tree_util.tree_map(np.asarray, params), load_config(cfgd))
    return {k: v.numpy().astype(np.float64) for k, v in sd.items()}


def _expected_var(kind, bound):
    return bound**2 / 3 if kind == "uniform" else (bound / 2) ** 2 * TRUNC_VAR


@pytest.mark.parametrize("init_scale", [0.0, 0.5])
def test_init_params_draws_from_the_jax_distributions(init_scale):
    """Tolerances: |w| <= bound * (1 + 1e-6) (f32 rounding of the bound);
    for a tensor of n >= 64 entries its sample variance within 6 standard
    errors of the rule's (relative standard error sqrt(0.8 / n) for a
    uniform, sqrt(1.37 / n) for the truncated normal, whose fourth moment
    is 2.37 sigma^4), and a max |w| above half the bound (the support is
    the rule's, not a narrower one)."""
    cfgd = tiny_config_dict(init_scale=init_scale)
    want = _jax_params(cfgd, 0)
    model = init_params(build_model(load_config(cfgd), device="cpu"),
                        torch.Generator().manual_seed(0))
    got = {k: p.detach().numpy().astype(np.float64)
           for k, p in model.named_parameters()}
    rules = init_rules(model)
    assert set(got) == set(want) == set(rules)
    zeros = {k for k, v in want.items() if not v.any()}
    assert zeros == {k for k, v in got.items() if not v.any()}
    assert any(k.endswith("proj_out.weight") for k in zeros)
    checked = 0
    for k, (kind, bound) in rules.items():
        g, w = got[k], want[k]
        if kind in ("zeros", "ones"):
            value = 0.0 if kind == "zeros" else 1.0
            assert (g == value).all() and (w == value).all(), k
            continue
        for name, x in (("port", g), ("jax", w)):
            assert np.abs(x).max() <= bound * (1 + 1e-6), (k, name, bound)
            if x.size >= 64:
                assert np.abs(x).max() > 0.5 * bound, (k, name, bound)
                var = _expected_var(kind, bound)
                se = np.sqrt((0.8 if kind == "uniform" else 1.37) / x.size)
                ratio = np.mean(x**2) / var
                assert abs(ratio - 1) <= 6 * se, (k, name, ratio, se)
                checked += 1
    assert checked > 150


def test_init_params_is_seeded():
    cfgd = tiny_config_dict()
    a, b, c = (init_params(build_model(load_config(cfgd), device="cpu"),
                           torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    for (k, x), y, z in zip(a.named_parameters(), b.parameters(),
                            c.parameters()):
        assert torch.equal(x, y), k
        if x.abs().max() > 0 and not torch.all(x == 1):
            assert not torch.equal(x, z), k


def test_trainer_starts_from_init_params(tmp_path):
    """cli/train one step (its update runs at lr 0, the warm-up's start):
    the parameters are init_params of config.seed, bit for bit."""
    write_records(tmp_path / "rec", 5, lengths=(9, 16))
    cfgd = tiny_config_dict()
    cfgd["training"].update({"batch_size": 2})
    cfgd["optim"] = {"warmup": 10}
    cfgd["seed"] = 5
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfgd))
    res = ttrain.main(["--config", str(tmp_path / "cfg.yml"), "--data",
                       str(tmp_path / "rec"), "--max_steps", "1",
                       "--device", "cpu", "--workdir_root",
                       str(tmp_path / "runs")])
    assert res["lrs"] == [0.0]
    want = init_params(build_model(load_config(cfgd), device="cpu"),
                       torch.Generator().manual_seed(5))
    got = dict(res["state"].model.named_parameters())
    for k, p in want.named_parameters():
        assert torch.equal(got[k], p), k
