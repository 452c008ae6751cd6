"""The port's bf16 gradients against the JAX package's, on the CPU.

jax.grad of the tiny model's train-mode DSM loss (dropout 0, injected t and
z, a 64-token caption, so every attention backward takes the kernel route;
the JAX attention through its Pallas kernels in interpret mode), in f32 and
in bf16 (`dtype` and `norm_dtype` bfloat16), against the port's bf16
`.grad`, all with the same params.

The bound is calibrated on the JAX package, against its f32 gradients: the
port's bf16 gradients must lie within half of the distance between JAX's
bf16 and f32 gradients. It is not held to JAX's bf16 gradients themselves:
XLA:CPU sums the backward's broadcast transposes (the gradients of every
bias, GroupNorm and LayerNorm parameter, and of each broadcast operand) as
a reduce in bf16, 0.47% off on a sum of 4096 terms, while the port
accumulates those sums in f32 (as cuBLAS, cuDNN and the TPU's MXU do), so
the two bf16 backward passes differ by about JAX's own bf16 error. The
forward's rounding points are held to JAX's in tests/test_torch_bf16.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import text2protein_tpu.ops.attention as jattn
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.diffusion.losses import (
    get_sde_loss_fn as j_get_sde_loss_fn,
)
from text2protein_tpu.diffusion.sde import get_sde as j_get_sde
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.diffusion.losses import get_sde_loss_fn
from text2protein_tpu_torch.diffusion.sde import get_sde
from text2protein_tpu_torch.interop.from_jax import (
    state_dict_from_flax_params,
)

from test_torch_bf16 import (
    BF16,
    _batch,
    _patch_pallas,
    port_model,
    random_params,
)
from torch_port_helpers import tiny_config_dict


def _flat(grads, keys):
    return np.concatenate([grads[k].ravel() for k in keys])


def test_bf16_gradients_within_half_of_jax_bf16_error():
    """Measured on the flattened gradient (max |diff| over max |JAX f32
    gradient|): JAX bf16 vs JAX f32 1.0e-2; the port's bf16 vs JAX f32
    1.8e-3, within half of it; the port's bf16 vs JAX bf16 1.0e-2 (XLA:CPU's
    bf16 sums, module docstring). The losses of the three agree to 4e-5."""
    params = random_params()
    batch, t, z = _batch(4)
    jres = {}
    with pytest.MonkeyPatch.context() as mp:
        _patch_pallas(mp)
        try:
            for name, model in (("f32", {}), ("bf16", BF16)):
                cfg = j_load_config(tiny_config_dict(**model))
                jsde, _ = j_get_sde(cfg)
                jloss = j_get_sde_loss_fn(jsde, j_build_model(cfg),
                                          train=True, condition=("length",))
                loss, grads = jax.jit(jax.value_and_grad(jloss))(
                    params, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(0), t=jnp.asarray(t),
                    z=jnp.asarray(z))
                jres[name] = (float(loss), {
                    k: v.numpy() for k, v in state_dict_from_flax_params(
                        jax.tree_util.tree_map(np.array, grads),
                        load_config(tiny_config_dict())).items()})
        finally:
            jattn.set_backend(None)

    cfg = load_config(tiny_config_dict(**BF16))
    tmodel = port_model(params, **BF16)
    tsde, _ = get_sde(cfg)
    tloss = get_sde_loss_fn(tsde, tmodel, train=True, condition=("length",))
    loss = tloss(None, {k: torch.from_numpy(v) for k, v in batch.items()},
                 t=torch.from_numpy(t), z=torch.from_numpy(z))
    loss.backward()
    got = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}

    (lf, gf), (lb, gb) = jres["f32"], jres["bf16"]
    keys = sorted(gf)
    assert set(got) == set(gb) == set(keys)
    vf, vb, vp = (_flat(g, keys) for g in (gf, gb, got))
    scale = np.abs(vf).max()
    jax_gap = np.abs(vb - vf).max() / scale
    port_gap = np.abs(vp - vf).max() / scale
    assert np.isfinite(vp).all()
    assert jax_gap > 1e-3, jax_gap  # bf16 really ran
    assert port_gap <= 0.5 * jax_gap, (port_gap, jax_gap)
    for a in (lb, loss.item()):
        assert abs(a - lf) <= 1e-4 * abs(lf)
