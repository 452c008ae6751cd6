"""The port's config keys that change the model's arithmetic.

Every `configs/*.yml` either builds in the port or is refused with
NotImplementedError naming the key the port does not compute yet
(`model.dtype` other than float32, `model.remat_resblocks`). A tiny UNet
with `norm_dtype: bfloat16` in an f32 network is held to the JAX package's
with the same settings: the same function there.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.interop.from_jax import (
    state_dict_from_flax_params,
)
from text2protein_tpu_torch.models.unet import build_model

from torch_port_helpers import (
    C,
    CONTEXT_DIM,
    N,
    flax_template,
    random_flax_params,
    rel_max_diff,
    tiny_config_dict,
)

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs")
                 .glob("*.yml"))
# the ymls whose model the port does not compute yet, and the key it names
REFUSED = {
    "quality_n256.yml": "model.dtype",
    "quality_n256_r5.yml": "model.dtype",
    "quality_ss_vp.yml": "model.dtype",
    "quality_text_cfgft.yml": "model.dtype",
}


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_builds_or_names_the_key_not_ported(path):
    """Widths are shrunk before building (the dtype keys stay)."""
    cfg = load_config(str(path))
    cfg.model.nf = 16
    cfg.model.num_res_blocks = 1
    cfg.model.context_dim = 16
    key = REFUSED.get(path.name)
    if key is not None:
        with pytest.raises(NotImplementedError, match=key):
            build_model(cfg, device="cpu")
        return
    model = build_model(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 0


@pytest.mark.parametrize("model,key", [
    ({"dtype": "bfloat16"}, "model.dtype"),
    ({"remat_resblocks": True}, "model.remat_resblocks"),
    ({"dtype": "float32", "remat_resblocks": True}, "model.remat_resblocks"),
])
def test_unported_model_keys_raise(model, key):
    cfg = load_config(tiny_config_dict(**model))
    with pytest.raises(NotImplementedError, match=key):
        build_model(cfg, device="cpu")


def test_norm_dtype_bf16_in_an_f32_unet_matches_jax():
    """`norm_dtype: bfloat16` with `dtype: float32`: the JAX GroupNorm
    normalizes in the input's dtype, f32 here, so the port's f32 UNet is
    the same function. Relative max diff < 2e-5, the UNet bar."""
    config = tiny_config_dict(norm_dtype="bfloat16", dtype="float32")
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, N, N, C)) * 5).astype(np.float32)
    labels = np.asarray([0.0, 50.0], np.float32)
    ctx = rng.standard_normal((2, 8, CONTEXT_DIM)).astype(np.float32)
    mask = np.ones((2, 8), bool)
    mask[0, 3:] = False
    jmodel = j_build_model(j_load_config(config))
    params = random_flax_params(
        flax_template(jmodel, x, labels, ctx, mask), 0)
    tcfg = load_config(config)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax_params(params, tcfg),
                           strict=True)
    want = np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(labels),
        context=jnp.asarray(ctx), context_mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(labels),
                     torch.from_numpy(ctx), torch.from_numpy(mask)).numpy()
    assert want.dtype == np.float32
    assert rel_max_diff(got, want) < 2e-5
