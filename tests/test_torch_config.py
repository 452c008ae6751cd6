"""The port's config keys that change the model's arithmetic, and its YAML
reader.

Every `configs/*.yml` builds in the port, with the yml's `model.dtype`,
`model.norm_dtype` and `model.remat_resblocks` (no model key is refused any
more), and its state dict is the f32 model's. A dtype the JAX `build_model`
does not take (its KeyError) is refused with NotImplementedError naming the
key.
A tiny UNet with `norm_dtype: bfloat16` in an f32 network is held to the
JAX package's with the same settings: the same function there.
`config.parse_yaml` (the port reads YAML without PyYAML) gives what
`yaml.safe_load` gives for every yml, value and type.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu_torch.config import (
    load_config,
    parse_yaml,
    quality_n256_config,
    save_config,
)
from text2protein_tpu_torch.interop.from_jax import (
    state_dict_from_flax_params,
)
from text2protein_tpu_torch.models.attention import SpatialTransformer
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
# the ymls whose model the port does not compute yet, and the key it names:
# none since model.dtype bfloat16 and model.remat_resblocks are ported
REFUSED = {}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _shrunk(path):
    """The yml's config at shrunk widths (the dtype and remat keys stay)."""
    cfg = load_config(str(path))
    cfg.model.nf = 16
    cfg.model.num_res_blocks = 1
    cfg.model.context_dim = 16
    return cfg


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_config_builds_or_names_the_key_not_ported(path):
    """Widths are shrunk before building. The model computes in the yml's
    dtype, with remat where the yml sets it; a bf16 yml's state dict takes
    the JAX model's params with strict=True."""
    cfg = _shrunk(path)
    key = REFUSED.get(path.name)
    if key is not None:
        with pytest.raises(NotImplementedError, match=key):
            build_model(cfg, device="cpu")
        return
    model = build_model(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 0
    dtype = str(cfg.model.get("dtype", "float32"))
    assert model.dtype == DTYPES[dtype]
    assert model.pre_conv.compute_dtype == DTYPES[dtype]
    assert model.out[2].compute_dtype == torch.float32  # the f32 head
    assert model.remat_resblocks == bool(cfg.model.get("remat_resblocks",
                                                       False))
    if dtype == "bfloat16":
        jcfg = j_load_config(str(path))
        for k in ("nf", "num_res_blocks", "context_dim"):
            jcfg.model[k] = cfg.model[k]
        n, c = cfg.data.max_res_num, cfg.data.num_channels
        template = flax_template(
            j_build_model(jcfg), np.zeros((1, n, n, c), np.float32),
            np.zeros((1,), np.float32), np.zeros((1, 4, 16), np.float32),
            np.ones((1, 4), bool))
        model.load_state_dict(state_dict_from_flax_params(
            random_flax_params(template, 0), cfg), strict=True)


@pytest.mark.parametrize("key", ["dtype", "norm_dtype"])
def test_a_dtype_jax_does_not_take_raises_naming_the_key(key):
    """float16: the JAX `build_model` has no entry for it (KeyError); the
    port raises NotImplementedError naming model.<key>."""
    cfg = load_config(tiny_config_dict(**{key: "float16"}))
    with pytest.raises(NotImplementedError, match=f"model.{key}"):
        build_model(cfg, device="cpu")


def test_quality_n256_builds_bf16_with_remat_at_full_width():
    """configs/quality_n256.yml as written: a bf16 model (f32 parameters)
    with remat of the residual and transformer blocks, and as many
    parameters as the JAX model of the same config (about 379M)."""
    cfg = quality_n256_config()
    assert cfg.model.dtype == "bfloat16" and cfg.model.remat_resblocks
    assert cfg.data.featurize_on_device and cfg.training.batch_size == 8
    model = build_model(cfg, device="cpu")
    assert model.dtype == torch.bfloat16 and model.remat_resblocks
    assert all(m.remat for m in model.modules()
               if isinstance(m, SpatialTransformer))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    shapes = jax.eval_shape(lambda: j_build_model(j_load_config(
        "configs/quality_n256.yml")).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 5)),
            jnp.zeros((1,)), jnp.zeros((1, 16, 4096)),
            jnp.ones((1, 16), bool))["params"])
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    got = sum(p.numel() for p in model.parameters())
    assert got == want and 370e6 < got < 390e6, (got, want)


def test_bf16_remat_model_has_the_f32_models_state_dict():
    """dtype, norm_dtype and remat change no key and no shape: the tiny
    bf16 remat model loads the f32 model's state dict with strict=True."""
    f32 = build_model(load_config(tiny_config_dict()), device="cpu")
    bf16 = build_model(load_config(tiny_config_dict(
        dtype="bfloat16", norm_dtype="bfloat16", remat_resblocks=True)),
        device="cpu")
    want = {k: v.shape for k, v in f32.state_dict().items()}
    assert {k: v.shape for k, v in bf16.state_dict().items()} == want
    bf16.load_state_dict(f32.state_dict(), strict=True)


def _typed(x):
    """A parsed YAML tree with each scalar's type kept (True != 1)."""
    if isinstance(x, dict):
        return {k: _typed(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_typed(v) for v in x]
    return (type(x).__name__, x)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_parse_yaml_reads_every_config_as_pyyaml(path):
    text = path.read_text()
    assert _typed(parse_yaml(text)) == _typed(yaml.safe_load(text))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_save_config_reads_back_equal(path, tmp_path):
    """`save_config` (the trainer's workdir config.yml) writes YAML that
    `parse_yaml` and PyYAML read back as the same config, types
    included."""
    cfg = load_config(path)
    save_config(cfg, tmp_path / "c.yml")
    text = (tmp_path / "c.yml").read_text()
    assert _typed(parse_yaml(text)) == _typed(cfg.to_dict())
    assert _typed(yaml.safe_load(text)) == _typed(cfg.to_dict())
    assert load_config(tmp_path / "c.yml") == cfg


def test_save_config_quotes_what_would_read_otherwise(tmp_path):
    d = {"s": {"word": "yes", "num": "1e-4", "int": "7", "empty": "",
               "hash": "a # b", "colon": "a: b", "nothing": "null",
               "quote": "it's", "slash": "lmsys/vicuna-7b-v1.3",
               "dash": "-x", "space": " x"},
         "f": [1e-4, 3.0, -2.5e-07, 1e20], "b": [True, None],
         "e": [], "m": {}}
    save_config(d, tmp_path / "c.yml")
    text = (tmp_path / "c.yml").read_text()
    assert _typed(parse_yaml(text)) == _typed(d)
    assert _typed(yaml.safe_load(text)) == _typed(d)
    with pytest.raises(ValueError, match="inf"):
        save_config({"x": float("inf")}, tmp_path / "inf.yml")


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
