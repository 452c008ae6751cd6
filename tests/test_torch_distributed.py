"""Train steps, the global norm and the PC sampler of the port on a
('data', 'model') mesh of ranks: each rank a process on the CPU, FSDP2 over
gloo (`parallel.launch.spawn`, a file store under a temporary directory,
every collective bound by a 60 s timeout), held to the one-device port and
to the JAX package's step on its 2 x 2 mesh of this machine's virtual CPU
devices.
"""

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from text2protein_tpu_torch.diffusion.sampling import get_pc_sampler
from text2protein_tpu_torch.diffusion.sde import get_sde
from text2protein_tpu_torch.graft_entry import dryrun_multichip
from text2protein_tpu_torch.parallel.launch import spawn
from text2protein_tpu_torch.training.steps import make_train_step

from torch_port_helpers import (  # noqa: F401  (a fixture)
    C,
    CONTEXT_DIM,
    N,
    one_torch_thread,
    tiny_config_dict,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B = 4        # the global batch
SEED = 5     # the train steps' seed
LR = 1e-4    # the configs' Adam learning rate
SPAWN_S = 300  # each multi-rank run's time limit (a loaded CPU is slow)


def _config(**optim):
    cfg = tiny_config_dict(dropout=0.1, condition=["length", "inpainting"])
    cfg["optim"] = {"warmup": 0, "lr": LR, "grad_clip": 1.0, **optim}
    return cfg


def _batch(rng, b=B):
    lengths = rng.integers(9, N + 1, b).astype(np.int32)
    row = np.arange(N)[None, :] < lengths[:, None]
    mask_pair = row[:, :, None] & row[:, None, :]
    coords = (rng.uniform(-1, 1, (b, N, N, C)).astype(np.float32)
              * mask_pair[..., None])
    coords[..., -1] = mask_pair
    ctx_mask = np.ones((b, 8), bool)
    ctx_mask[0, 5:] = False
    return {"coords_6d": coords, "mask_pair": mask_pair,
            "ss_spans": np.full((b, 32, 2), -1, np.int32),
            "length": lengths,
            "context": rng.standard_normal((b, 8, CONTEXT_DIM))
            .astype(np.float32),
            "context_mask": ctx_mask}


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [_batch(rng) for _ in range(3)]


@pytest.fixture(scope="module")
def one_device(batches):
    """The one-device port's 3 steps on the global batches."""
    cfg, state = W.build_state(_config())
    sde, _ = get_sde(cfg)
    step = make_train_step(cfg, sde, state.model)
    norms = W.recording_norms(state)
    losses = [float(step(state, W.tensors(b), SEED)) for b in batches]
    return {"losses": losses, "norms": norms, **W.host_state(state)}


# The attention key biases (`NIN_1.b`) have a gradient of 0 in exact
# arithmetic (softmax ignores a shift of a whole row), so each run's is
# rounding noise, and Adam turns noise of either sign into a step of about
# +-lr: those are held to 2 lr a step, every other tensor to 1e-5 of its
# scale (floored at the lr x steps that Adam can move it).
def _zero_grad_param(name):
    return name.endswith("NIN_1.b")


def _assert_states_close(got, want, steps):
    for kind in ("params", "ema"):
        for k, w in want[kind].items():
            diff = np.abs(got[kind][k] - w).max()
            if _zero_grad_param(k):
                assert diff <= 2 * LR * steps, (kind, k, diff)
            else:
                assert diff <= 1e-5 * max(np.abs(w).max(), LR * steps), (
                    kind, k, diff)


@pytest.mark.parametrize("data,model", [(2, 1), (2, 2)],
                         ids=["world2_data2", "world4_data2_model2"])
def test_sharded_train_steps_match_one_device(batches, one_device, data,
                                              model):
    """3 train steps with dropout 0.1 and random inpainting masks, the clip
    triggered: each rank's rows of every draw are the one-device draws' (so
    the losses agree to the rounding of the reductions, rtol 1e-5), the
    gradient norms too, and every rank ends with the same parameters and
    EMA, those of the one-device run."""
    assert max(one_device["norms"]) > 1.0  # the clip acts
    res = spawn(W.train_steps, data * model,
                args=(_config(), data, model, batches, SEED), device="cpu",
                timeout=SPAWN_S)
    got = res[0]
    np.testing.assert_allclose(got["losses"], one_device["losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["norms"], one_device["norms"], rtol=1e-5)
    _assert_states_close(got, one_device, len(batches))
    for other in res[1:]:
        assert other["losses"] == got["losses"]
        for kind in ("params", "ema"):
            for k, v in got[kind].items():
                np.testing.assert_array_equal(other[kind][k], v)
    want = "Replicate(), Shard(dim=0)"
    assert all(want in p for p in got["placements"].values())


def test_sharded_step_matches_jax_data2_model2():
    """The port on 4 ranks (data 2 x model 2, FSDP2) against the JAX
    package's loss and gradients on make_mesh(data=2, model=2) of the
    virtual CPU devices (params sharded by its FSDP rule, the batch over
    'data'), the same weights, injected t and z, dropout 0: the loss within
    rtol 2e-4, every gradient within 1e-3 of its scale (floored at 1e-3 of
    the largest gradient, as the key biases' are rounding noise)."""
    import jax
    import jax.numpy as jnp

    import text2protein_tpu.ops.attention as jattn
    from text2protein_tpu.config import load_config as j_load_config
    from text2protein_tpu.diffusion.losses import get_sde_loss_fn
    from text2protein_tpu.diffusion.sde import get_sde as j_get_sde
    from text2protein_tpu.models import build_model as j_build_model
    from text2protein_tpu.parallel.mesh import (
        batch_sharding,
        make_mesh,
        put_array,
        shard_batch,
        shard_params,
    )
    from text2protein_tpu_torch.config import load_config
    from text2protein_tpu_torch.interop.from_jax import (
        state_dict_from_flax_params,
    )
    from torch_port_helpers import flax_template, random_flax_params

    cfg = tiny_config_dict()
    rng = np.random.default_rng(4)
    batch = _batch(rng)
    t = rng.uniform(1e-5, 1.0, B).astype(np.float32)
    z = rng.standard_normal((B, N, N, C)).astype(np.float32)
    jmodel = j_build_model(j_load_config(cfg))
    params = random_flax_params(
        flax_template(jmodel, batch["coords_6d"], np.zeros(B),
                      batch["context"], batch["context_mask"]), 3)
    sd = {k: v.numpy() for k, v in
          state_dict_from_flax_params(params, load_config(cfg)).items()}

    jattn.set_backend("xla")  # the Pallas kernels' plain reference
    try:
        mesh = make_mesh(data=2, model=2, devices=jax.devices()[:4])
        jsde, _ = j_get_sde(j_load_config(cfg))
        loss_fn = get_sde_loss_fn(jsde, jmodel, train=True,
                                  condition=("length",))
        bsh = batch_sharding(mesh)
        fn = jax.jit(jax.value_and_grad(
            lambda p, b, t, z: loss_fn(p, b, jax.random.PRNGKey(0), t=t,
                                       z=z)))
        jbatch = {k: v for k, v in batch.items() if k != "length"}
        want_loss, jgrads = fn(shard_params(mesh, params),
                               shard_batch(mesh, jbatch),
                               put_array(jnp.asarray(t), bsh),
                               put_array(jnp.asarray(z), bsh))
    finally:
        jattn.set_backend(None)
    want = {k: v.numpy() for k, v in state_dict_from_flax_params(
        jax.tree_util.tree_map(np.array, jgrads),
        load_config(cfg)).items()}

    got = spawn(W.loss_and_grads, 4, args=(cfg, sd, 2, 2, batch, t, z),
                device="cpu", timeout=SPAWN_S)[0]
    np.testing.assert_allclose(got["loss"], float(want_loss), rtol=2e-4)
    assert set(got["grads"]) == set(want)
    floor = 1e-3 * max(np.abs(w).max() for w in want.values())
    worst = max((np.abs(got["grads"][k] - w).max()
                 / max(np.abs(w).max(), floor), k) for k, w in want.items())
    assert worst[0] < 1e-3, worst


def test_sharded_global_norm_matches_unsharded(one_device):
    """global_norm and clip_by_global_norm over gradients sharded on data 2
    x model 2 (each rank sums its shards' squares, the sums added over the
    'model' ranks) against the same on whole tensors: the norm within rtol
    1e-6, the clipped gradients within 1e-6 of their scale; the head's
    shards are uneven."""
    from text2protein_tpu_torch.training.state import (
        clip_by_global_norm,
        global_norm,
    )

    rng = np.random.default_rng(7)
    grads = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in one_device["params"].items()}
    whole = [torch.from_numpy(g.copy()) for g in grads.values()]
    want = float(global_norm(whole))
    clip = want / 3
    assert float(clip_by_global_norm(whole, clip)) == want
    res = spawn(W.global_norms, 4, args=(_config(), 2, 2, grads, clip),
                device="cpu", timeout=SPAWN_S)
    for r in res:
        np.testing.assert_allclose([r["norm"], r["clip_norm"]], want,
                                   rtol=1e-6)
        for (k, g), w in zip(r["clipped"].items(), whole):
            assert np.abs(g - w.numpy()).max() <= 1e-6 * np.abs(
                w.numpy()).max(), k
    # model rank 1 holds the second chunk of dim 0: the head's 5 output
    # channels split 3 + 2
    shapes = res[1]["local_shapes"]
    assert shapes["out.2.bias"] == (2,)
    assert all(2 * s[0] <= one_device["params"][k].shape[0] <= 2 * s[0] + 1
               for k, s in shapes.items())


def test_batch_sharded_pc_sampler_world2_matches_world1():
    """The PC sampler on 2 data ranks, each sampling its rows with every
    draw made for the global batch, gathered: the one-device sampler's
    samples on the same generator seed (8 steps, within 1e-5 of scale)."""
    from torch_dist_workers import build_state

    cfg = tiny_config_dict()
    batch = _batch(np.random.default_rng(9))
    got = spawn(W.pc_samples, 2, args=(cfg, 2, 1, batch, 11, 8),
                device="cpu", timeout=SPAWN_S)
    c, state = build_state(cfg)
    sde, _ = get_sde(c)
    rows = W.tensors(batch)
    sampler = get_pc_sampler(sde, state.model, (B, N, N, C), num_steps=8)
    want, _ = sampler(torch.Generator().manual_seed(11),
                      condition={"length": rows["mask_pair"]},
                      context=rows["context"],
                      context_mask=rows["context_mask"])
    want = want.numpy()
    for g in got:
        assert g.shape == want.shape
        assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max()


def test_dryrun_multichip_four_ranks_on_cpu():
    """dryrun_multichip(4) on the CPU: a data 2 x model 2 mesh, one sharded
    train step with the pair grid's rows split over `model` (the JAX
    dryrun's shard_grid) and the batch-sharded PC sampler (8 steps),
    finite."""
    res = dryrun_multichip(4, device="cpu", timeout=SPAWN_S)
    assert res["mesh"] == {"data": 2, "model": 2}
    assert res["shard_grid"] is True
    assert res["step"] == 1 and np.isfinite(res["loss"])
    assert res["samples"].shape == (4, 16, 16, 5)
    assert np.isfinite(res["samples"]).all() and res["nfe"] == 16
