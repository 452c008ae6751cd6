"""The port's score UNet and its layers against the JAX package.

Random flax params (every leaf, proj_out included) are carried across with
`interop.from_jax.state_dict_from_flax_params` and loaded with strict=True;
both forwards run in f32 on the same numpy inputs. Bar: relative max diff
< 2e-5, the parity bar of the JAX package's own torch harness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu.models import layers as jlayers
from text2protein_tpu_torch.config import flagship_config, load_config
from text2protein_tpu_torch.interop.from_jax import (
    state_dict_from_flax_params,
)
from text2protein_tpu_torch.models import layers as tlayers
from text2protein_tpu_torch.models.unet import (
    ScoreUNet,
    build_model,
    init_random_weights,
)

from torch_port_helpers import (
    C,
    CONTEXT_DIM,
    N,
    NUM_SCALES,
    flax_template,
    random_flax_params,
    rel_max_diff,
    tiny_config_dict,
)


def _pair(config_dict, x, labels, ctx, ctx_mask, seed=0):
    """(jax model, params, port model) with the same random weights."""
    jcfg = j_load_config(config_dict)
    jmodel = j_build_model(jcfg)
    template = flax_template(jmodel, x, labels, ctx, ctx_mask)
    params = random_flax_params(template, seed)
    tmodel = build_model(load_config(config_dict), device="cpu")
    tmodel.load_state_dict(
        state_dict_from_flax_params(params, load_config(config_dict)),
        strict=True)
    return jmodel, params, tmodel


def _forward(jmodel, params, tmodel, x, labels, ctx, ctx_mask):
    j = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(labels),
                     context=None if ctx is None else jnp.asarray(ctx),
                     context_mask=(None if ctx_mask is None
                                   else jnp.asarray(ctx_mask)))
    with torch.no_grad():
        t = tmodel(torch.from_numpy(x), torch.from_numpy(labels),
                   None if ctx is None else torch.from_numpy(ctx),
                   None if ctx_mask is None else torch.from_numpy(ctx_mask))
    return np.asarray(j), t.numpy()


@pytest.fixture(scope="module")
def tiny_pair():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, N, N, C)).astype(np.float32)
    ctx = rng.standard_normal((2, 8, CONTEXT_DIM)).astype(np.float32)
    return _pair(tiny_config_dict(), x, np.zeros(2, np.float32), ctx,
                 np.ones((2, 8), bool))


@pytest.mark.parametrize("case", ["caption", "padded_mask", "no_context"])
@pytest.mark.parametrize("labels", [[0.0, 50.0], [NUM_SCALES - 1.0, 13.0]])
def test_unet_forward_matches_jax(tiny_pair, case, labels):
    """Labels at both ends of the sigma ladder (scale_by_sigma divides by
    sigma_max and by sigma_min); a caption with every token live, one with a
    padded key mask, and context=None (cross-attention becomes
    self-attention)."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, N, N, C)) * 5).astype(np.float32)
    ctx = rng.standard_normal((2, 8, CONTEXT_DIM)).astype(np.float32)
    mask = np.ones((2, 8), bool)
    if case == "padded_mask":
        mask[0, 3:] = False
        mask[1, 6:] = False
    if case == "no_context":
        ctx = mask = None
    j, t = _forward(*tiny_pair, x, np.asarray(labels, np.float32), ctx, mask)
    assert t.shape == (2, N, N, C)
    assert rel_max_diff(t, j) < 2e-5


def test_flagship_unet_forward_matches_jax():
    """The flagship L=128 widths at B=1, with a padded 64-token caption."""
    cfg = flagship_config()
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((1, 128, 128, 5)) * 10).astype(np.float32)
    ctx = rng.standard_normal((1, 64, 512)).astype(np.float32)
    mask = np.zeros((1, 64), bool)
    mask[0, :20] = True
    labels = np.asarray([1000.0], np.float32)
    jmodel, params, tmodel = _pair(cfg.to_dict(), x, labels, ctx, mask)
    j, t = _forward(jmodel, params, tmodel, x, labels, ctx, mask)
    assert rel_max_diff(t, j) < 2e-5


def test_flagship_config_matches_jax_entry():
    """flagship_config() has the widths of the JAX package's flagship
    (`__graft_entry__._flagship_config`)."""
    import __graft_entry__

    want = __graft_entry__._flagship_config()
    got = flagship_config()
    for sec, keys in {
        "data": ["max_res_num", "num_channels"],
        "model": ["nf", "ch_mult", "num_res_blocks", "attn_resolutions",
                  "n_heads", "context_dim", "sigma_min", "sigma_max",
                  "num_scales", "resblock_type", "skip_rescale",
                  "scale_by_sigma", "nonlinearity", "condition"],
        "text": ["encoder", "pad_to_bucket", "max_tokens"],
        "sampling": ["method", "predictor", "corrector", "snr",
                     "n_steps_each", "noise_removal"],
        "training": ["sde"],
    }.items():
        for k in keys:
            assert got[sec][k] == want[sec][k], (sec, k)
    assert got.seed == want.seed


def test_state_dict_keys_are_the_reference_layout():
    cfg = load_config(tiny_config_dict())
    model = ScoreUNet(num_channels=C, max_res_num=N, nf=32, ch_mult=(1, 2),
                      attn_resolutions=(8,), n_heads=4,
                      context_dim=CONTEXT_DIM, num_scales=NUM_SCALES)
    keys = set(model.state_dict())
    assert "sigmas" not in keys
    for k in ("pre_blocks.0.weight", "pre_conv.weight", "out.0.weight",
              "out.2.bias", "input_blocks.3.1.NIN_0.W",
              "input_blocks.3.2.proj_in.weight",
              "input_blocks.3.2.transformer_blocks.0.attn1.to_out.0.weight",
              "input_blocks.3.2.transformer_blocks.0.ff.net.0.proj.weight",
              "mid_blocks.2.proj_out.weight", "out_blocks.0.0.Conv_2.weight"):
        assert k in keys, k
    assert cfg.model.nf == 32


def test_from_jax_refuses_unknown_leaves():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, N, N, C)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, CONTEXT_DIM)).astype(np.float32)
    jmodel = j_build_model(j_load_config(tiny_config_dict()))
    params = flax_template(jmodel, x, np.zeros(1, np.float32), ctx,
                           np.ones((1, 8), bool))
    params["Stray_0"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="Stray_0"):
        state_dict_from_flax_params(params, load_config(tiny_config_dict()))


def test_init_random_weights_is_seeded_and_no_tensor_is_zero():
    cfg = load_config(tiny_config_dict())
    a = init_random_weights(build_model(cfg, device="cpu"), 3)
    b = init_random_weights(build_model(cfg, device="cpu"), 3)
    c = init_random_weights(build_model(cfg, device="cpu"), 4)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        assert not torch.equal(pa, pc), name
        assert torch.count_nonzero(pa) > 0.99 * pa.numel(), name


def test_build_model_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(load_config(tiny_config_dict()))


# ------------------------------------------------------------------- layers

def _flax_apply(module, x, seed=0, **kw):
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), **kw)
    params = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(seed).standard_normal(a.shape)
        .astype(np.float32) * 0.3, params)
    return params, np.asarray(module.apply(params, jnp.asarray(x), **kw))


@pytest.mark.parametrize("ch", [4, 12, 96, 144, 256])
def test_num_groups_matches_jax(ch):
    assert tlayers._num_groups(ch) == jlayers._num_groups(ch)


@pytest.mark.parametrize("groups,ch", [(32, 64), (8, 24), (3, 144)])
def test_group_norm_matches_jax(groups, ch):
    """f32 statistics with variance E[x^2] - E[x]^2 and eps 1e-6, on inputs
    with a large mean where the variance formula shows."""
    x = (np.random.default_rng(2).standard_normal((2, 8, 8, ch)) * 3 + 4
         ).astype(np.float32)
    params, want = _flax_apply(
        jlayers.GroupNormF32Stats(num_groups=groups, epsilon=1e-6), x)
    p = params["params"]
    gn = tlayers.GroupNormF32Stats(groups, ch)
    gn.weight.data = torch.from_numpy(np.asarray(p["scale"]))
    gn.bias.data = torch.from_numpy(np.asarray(p["bias"]))
    with torch.no_grad():
        got = gn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t_max,atol", [(17.0, 1e-5), (1999.0, 1e-4)])
def test_timestep_embedding_matches_jax(t_max, atol):
    """XLA's f32 exp on the CPU is off by one ulp for a few frequencies
    (torch's is correctly rounded), and sin(t * f) multiplies that by t:
    atol 1e-5 up to t = 17, 1e-4 up to the top of the 2000-label ladder."""
    t = np.asarray([0.0, 1.0, t_max / 2, t_max], np.float32)
    for dim in (32, 33, 128):
        want = np.asarray(jlayers.get_timestep_embedding(jnp.asarray(t), dim))
        got = tlayers.get_timestep_embedding(torch.from_numpy(t), dim)
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=1e-5)


@pytest.mark.parametrize("kind", ["down", "up"])
def test_resample_layers_match_jax(kind):
    """Downsample pads right and bottom before a VALID stride-2 conv; flax
    conv kernels are (kh, kw, in, out)."""
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 6)).astype(
        np.float32)
    jmod = jlayers.Downsample() if kind == "down" else jlayers.Upsample()
    params, want = _flax_apply(jmod, x)
    conv = params["params"]["Conv_0"]
    tmod = tlayers.Downsample(6) if kind == "down" else tlayers.Upsample(6)
    tmod.Conv_0.weight.data = torch.from_numpy(
        np.asarray(conv["kernel"]).transpose(3, 2, 0, 1).copy())
    tmod.Conv_0.bias.data = torch.from_numpy(np.asarray(conv["bias"]))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_naive_resampling_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 8, 8, 3)).astype(
        np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for jf, tf in ((jlayers.naive_upsample_2d, tlayers.naive_upsample_2d),
                   (jlayers.naive_downsample_2d,
                    tlayers.naive_downsample_2d)):
        want = np.asarray(jf(jnp.asarray(x)))
        got = tf(xt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_ddpm_resblock_matches_jax():
    """ResnetBlockDDPM with a NIN shortcut (the resblock the flagship does
    not use, kept for `resblock_type: ddpm`)."""
    x = np.random.default_rng(6).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    temb = np.random.default_rng(7).standard_normal((2, 20)).astype(
        np.float32)
    jmod = jlayers.ResnetBlockDDPM(act=jax.nn.silu, out_ch=32,
                                   skip_rescale=True, dropout=0.0)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(temb))
    params = jax.tree_util.tree_map(
        lambda a: np.random.default_rng(1).standard_normal(a.shape)
        .astype(np.float32) * 0.2, params)
    want = np.asarray(jmod.apply(params, jnp.asarray(x), jnp.asarray(temb)))
    p = params["params"]
    tmod = tlayers.ResnetBlockDDPM(torch.nn.functional.silu, 16, 32, 20,
                                   dropout=0.0, skip_rescale=True).eval()
    sd = {
        "GroupNorm_0.weight": p["GroupNormF32Stats_0"]["scale"],
        "GroupNorm_0.bias": p["GroupNormF32Stats_0"]["bias"],
        "Conv_0.weight": np.asarray(p["Conv_0"]["kernel"]).transpose(
            3, 2, 0, 1),
        "Conv_0.bias": p["Conv_0"]["bias"],
        "Dense_0.weight": np.asarray(p["Dense_0"]["kernel"]).T,
        "Dense_0.bias": p["Dense_0"]["bias"],
        "GroupNorm_1.weight": p["GroupNormF32Stats_1"]["scale"],
        "GroupNorm_1.bias": p["GroupNormF32Stats_1"]["bias"],
        "Conv_1.weight": np.asarray(p["Conv_1"]["kernel"]).transpose(
            3, 2, 0, 1),
        "Conv_1.bias": p["Conv_1"]["bias"],
        "NIN_0.W": p["Dense_1"]["kernel"],
        "NIN_0.b": p["Dense_1"]["bias"],
    }
    tmod.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2),
                   torch.from_numpy(temb)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
