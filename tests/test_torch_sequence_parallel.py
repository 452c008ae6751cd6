"""Sequence parallelism in the port (`parallel/sequence.py`, the train
step's `shard_grid`) on the CPU: the pair grid's rows split over the
`model` ranks, held to the unsharded port and to the JAX package's
`shard_grid` path.

Both row groups run here: `StackedRowGroup` (the ranks stacked on the
batch axis of one process) and `DistRowGroup` (a process a rank, gloo,
launched by `parallel.launch.spawn` as tests/test_torch_distributed.py
does: one 4-rank run serves every gloo check of this file).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_workers as W
from text2protein_tpu_torch.diffusion.losses import get_sde_loss_fn
from text2protein_tpu_torch.diffusion.sde import get_sde
from text2protein_tpu_torch.models import layers
from text2protein_tpu_torch.models.attention import CrossAttention
from text2protein_tpu_torch.parallel.launch import spawn
from text2protein_tpu_torch.parallel.mesh import (
    Mesh,
    RowGenerator,
    grid_rows,
    rand,
    row_generator,
    shard_batch,
)
from text2protein_tpu_torch.parallel.sequence import (
    StackedRowGroup,
    check_grid,
    rows_split,
)
from text2protein_tpu_torch.training.steps import make_train_step

from torch_port_helpers import (  # noqa: F401  (a fixture)
    C,
    CONTEXT_DIM,
    N,
    one_torch_thread,
    tiny_config_dict,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

B = 4          # the global batch
SEED = 5       # the train steps' seed
LR = 1e-4      # the train configs' Adam learning rate
SPAWN_S = 300  # the 4-rank run's time limit (a loaded CPU is slow)
REPO = Path(__file__).resolve().parents[1]


def _whole(group, y, dim):
    """A stacked group's tensor (the ranks' rows on the batch axis) as the
    whole grid: each rank's block put back along `dim`."""
    return torch.cat(y.chunk(group.size), dim)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _set_group(module, group):
    for m in module.modules():
        if hasattr(type(m), "row_group"):
            m.row_group = group


# (layer, input shape, the axis of the grid's rows in the input)
LAYERS = {
    "conv3x3": (lambda: layers.conv3x3(6, 8), (2, 6, 16, 16), 2),
    "group_norm": (lambda: layers.group_norm(16), (2, 16, 16, 16), 2),
    "attn_block": (lambda: layers.AttnBlock(16, skip_rescale=True),
                   (2, 16, 8, 8), 2),
    # 4 heads of 8 over the row-major tokens of an 8 x 8 grid
    "self_attention": (lambda: CrossAttention(32, None, 4, 8),
                       (2, 64, 32), 1),
}


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", list(LAYERS))
def test_row_group_layer_matches_unsharded(name, size):
    """Each layer that crosses a rank's rows (the halo-exchanged 3x3
    convolution, GroupNorm's summed statistics, the AttnBlock's and the
    self-attention's gathered keys and values), with the rows split over a
    stacked group of 2 or 4 ranks, against the same layer on whole grids:
    the forward within 1e-6 of its scale, the input's and every
    parameter's gradient (of a random linear function of the output)
    within 1e-5 of its scale, floored at 1e-3 of the layer's largest; the
    AttnBlock's key bias (`NIN_1.b`, a gradient of 0 in exact arithmetic:
    softmax ignores a shift of a whole row, so both sides are rounding)
    within 1e-5 of the layer's largest gradient."""
    make, shape, dim = LAYERS[name]
    torch.manual_seed(0)
    layer = make()
    with torch.no_grad():  # every parameter live, norm scales near 1
        for k, p in layer.named_parameters():
            scale = 0.1 if p.ndim == 1 else p[0].numel() ** -0.5
            p.copy_(torch.randn(p.shape) * scale
                    + (1.0 if p.ndim == 1 and k.endswith("weight") else 0.0))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=gen)
    w = torch.randn(layer(x).shape, generator=gen)

    def run(group):
        layer.zero_grad()
        _set_group(layer, group)
        xi = x if group is None else group.local_rows(group.tile(x), dim)
        wi = w if group is None else group.local_rows(group.tile(w), dim)
        xi = xi.detach().requires_grad_()
        y = layer(xi)
        (y * wi).sum().backward()
        grads = {k: p.grad.clone() for k, p in layer.named_parameters()}
        if group is not None:
            y, xi = _whole(group, y, dim), _whole(group, xi.grad, dim)
            return y.detach(), xi, grads
        return y.detach(), xi.grad, grads

    y0, dx0, g0 = run(None)
    group = StackedRowGroup(size)
    y1, dx1, g1 = run(group)
    _set_group(layer, None)
    assert _rel(y1, y0) <= 1e-6
    assert _rel(dx1, dx0) <= 1e-5
    largest = max(g.abs().max() for g in g0.values())
    for k, g in g0.items():
        scale = largest if k == "NIN_1.b" else max(g.abs().max(),
                                                   1e-3 * largest)
        assert (g1[k] - g).abs().max() <= 1e-5 * scale, k


def test_grid_draws_are_the_whole_grids_rows():
    """A RowGenerator's draw of the grid is the whole grid's draw, cut to
    the rank's rows: on rank `block` of 4 its block, stacked every block
    on the batch axis; a draw that is not of the grid is the batch's (the
    same on every rank, tiled when stacked)."""
    def gen():
        return torch.Generator().manual_seed(3)

    whole = rand((2, 5, 16, 16), gen())
    for block in range(4):
        got = rand((2, 5, 4, 16), RowGenerator(gen(), 0, 2, 2, 4, block),
                   rows_dim=2)
        torch.testing.assert_close(got, whole[:, :, 4 * block:4 * block + 4],
                                   rtol=0, atol=0)
    group = StackedRowGroup(4)
    stacked = row_generator(gen(), None, 2, group)
    torch.testing.assert_close(
        rand((8, 5, 4, 16), stacked, rows_dim=2),
        group.local_rows(group.tile(whole), 2), rtol=0, atol=0)
    t = rand((2,), gen())
    torch.testing.assert_close(rand((8,), row_generator(gen(), None, 2,
                                                        group)),
                               t.repeat(4), rtol=0, atol=0)


def test_shard_batch_splits_the_grid_rows_at_n256():
    """shard_batch(..., shard_grid=True) at N=256 on data 2 x model 4 (the
    JAX test_sp_long_context_n256's mesh): coords_6d (1, 64, 256, 5) on
    every rank, mask_pair (1, 64, 256), the other keys by batch only; the
    ranks' blocks make the whole grid, in rank order."""
    rng = np.random.default_rng(0)
    batch = {"coords_6d": rng.standard_normal((2, 256, 256, 5))
             .astype(np.float32),
             "mask_pair": rng.uniform(size=(2, 256, 256)) < 0.5,
             "length": np.array([200, 256], np.int32),
             "context": np.zeros((2, 8, 16), np.float32)}
    rows = [shard_batch(Mesh(2, 4, rank), batch, shard_grid=True)
            for rank in range(8)]
    assert {r["coords_6d"].shape for r in rows} == {(1, 64, 256, 5)}
    assert {r["mask_pair"].shape for r in rows} == {(1, 64, 256)}
    assert {r["length"].shape for r in rows} == {(1,)}
    assert {r["context"].shape for r in rows} == {(1, 8, 16)}
    for d in range(2):
        np.testing.assert_array_equal(
            np.concatenate([rows[4 * d + m]["coords_6d"]
                            for m in range(4)], axis=1),
            batch["coords_6d"][d:d + 1])
    # without shard_grid the grid stays whole
    assert shard_batch(Mesh(2, 4, 5), batch)["coords_6d"].shape == (
        1, 256, 256, 5)


def test_rows_that_do_not_split_evenly_raise():
    """Where N / 2^(levels - 1) is not a multiple of model, the rows do not
    split evenly (XLA would pad the shards): check_grid, the train step and
    shard_batch raise ValueError naming the sizes."""
    with pytest.raises(ValueError, match=r"16 rows over 2 levels .* "
                       r"model=3"):
        check_grid(16, 2, 3)
    with pytest.raises(ValueError, match="model=16"):
        check_grid(16, 2, 16)  # 8 rows at the coarsest level
    check_grid(16, 2, 8)
    cfg, state = W.build_state(tiny_config_dict())
    sde, _ = get_sde(cfg)
    with pytest.raises(ValueError, match="model=3"):
        make_train_step(cfg, sde, state.model, shard_grid=StackedRowGroup(3))
    with pytest.raises(ValueError, match="model=3"):
        grid_rows(Mesh(1, 3, 0), 16)
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(cfg, sde, state.model, shard_grid=True)


# ----------------------------------------------------------- the train step


def _train_cfg(**model):
    model = {"dropout": 0.1, "condition": ["length", "inpainting"], **model}
    cfg = tiny_config_dict(**model)
    cfg["optim"] = {"warmup": 0, "lr": LR, "grad_clip": 1.0}
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


def _steps(cfg_dict, batches, group=None):
    """The port's train steps on one process, plain or with the rows split
    over a stacked group: losses, gradient norms, the last step's
    (clipped) gradients, params and EMA."""
    cfg, state = W.build_state(cfg_dict)
    sde, _ = get_sde(cfg)
    step = make_train_step(cfg, sde, state.model, shard_grid=group or False)
    norms = W.recording_norms(state)
    losses = []
    for b in batches:
        b = W.tensors(b) if isinstance(b["length"], np.ndarray) else b
        losses.append(float(step(state, b if group is None
                                 else group.shard_batch(b), SEED)))
    return {"losses": losses, "norms": norms,
            "grads": {k: p.grad.numpy()
                      for k, p in state.model.named_parameters()},
            **W.host_state(state)}


def _assert_steps_close(got, want, loss_rtol=1e-5, grad_tol=1e-4,
                        tol=2e-4):
    """Losses and gradient norms within `loss_rtol` (the norm carries the
    gradient's scale: a gradient `model` times too large shows there, not
    in Adam's update); every gradient within `grad_tol` of its scale,
    floored at 1e-3 of the largest (f32 through the whole backward, with
    GroupNorm's sums and the convolutions' in another order: 1e-5 of
    scale at worst measured, hence 1e-4); params and EMA within `tol` of
    their scale, floored at the lr x steps Adam can move them (Adam's
    first update is lr x g / (|g| + eps): an element whose gradient is
    near eps moves by rounding, up to 9.4e-5 of scale measured, hence
    2e-4, which is 2 lr at a scale of 1: an update of the wrong sign on
    an element that moves shows). The
    attention key biases (`NIN_1.b`) have a gradient of 0 in exact
    arithmetic: Adam turns its rounding noise into steps of +-lr, held to
    2 lr a step. Returns the worst relative gradient and parameter
    differences and their names."""
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=loss_rtol)
    np.testing.assert_allclose(got["norms"], want["norms"], rtol=loss_rtol)
    floor = 1e-3 * max(np.abs(g).max() for g in want["grads"].values())
    worst_grad = max((np.abs(got["grads"][k] - g).max()
                      / max(np.abs(g).max(), floor), k)
                     for k, g in want["grads"].items())
    assert worst_grad[0] <= grad_tol, worst_grad
    steps = len(want["losses"])
    worst_param = (0.0, None)
    for kind in ("params", "ema"):
        for k, w in want[kind].items():
            diff = np.abs(got[kind][k] - w).max()
            if k.endswith("NIN_1.b"):
                assert diff <= 2 * LR * steps, (kind, k, diff)
                continue
            scale = max(np.abs(w).max(), LR * steps)
            assert diff <= tol * scale, (kind, k, diff)
            worst_param = max(worst_param, (diff / scale, f"{kind} {k}"))
    return worst_grad, worst_param


@pytest.fixture(scope="module")
def jax_case():
    """JAX's loss with the pair grid sharded as its make_train_step(...,
    shard_grid=True) step takes it (params FSDP over 'model', the batch
    and t over 'data', the grid keys and z over ('data', 'model')) on
    make_mesh(data=4, model=2) of the virtual CPU devices, at
    tests/helpers.tiny_config with random weights and injected t and z
    (its train step draws them inside; the attention through the Pallas
    kernels' plain reference); and the same weights for the port."""
    import jax
    import jax.numpy as jnp

    import text2protein_tpu.ops.attention as jattn
    from helpers import tiny_batch, tiny_config
    from text2protein_tpu.diffusion.losses import (
        get_sde_loss_fn as j_get_sde_loss_fn,
    )
    from text2protein_tpu.diffusion.sde import get_sde as j_get_sde
    from text2protein_tpu.models import build_model as j_build_model
    from text2protein_tpu.parallel.mesh import (
        batch_sharding,
        grid_sharding,
        make_mesh,
        put_array,
        shard_batch as j_shard_batch,
        shard_params,
    )
    from text2protein_tpu_torch.config import load_config
    from text2protein_tpu_torch.interop.from_jax import (
        state_dict_from_flax_params,
    )
    from torch_port_helpers import flax_template, random_flax_params

    jcfg = tiny_config()
    jbatch = {k: np.asarray(v) for k, v in tiny_batch(jcfg, b=B).items()}
    jmodel = j_build_model(jcfg)
    params = random_flax_params(
        flax_template(jmodel, jbatch["coords_6d"], np.zeros(B),
                      jbatch["context"], jbatch["context_mask"]), 3)
    cfg_dict = jcfg.to_dict()
    sd = {k: v.numpy() for k, v in state_dict_from_flax_params(
        params, load_config(cfg_dict)).items()}
    rng = np.random.default_rng(4)
    t = rng.uniform(1e-5, 1.0, B).astype(np.float32)
    z = rng.standard_normal(jbatch["coords_6d"].shape).astype(np.float32)
    jattn.set_backend("xla")
    try:
        mesh = make_mesh(data=4, model=2, devices=jax.devices()[:8])
        jsde, _ = j_get_sde(jcfg)
        loss_fn = j_get_sde_loss_fn(jsde, jmodel, train=True,
                                    condition=tuple(jcfg.model.condition))
        fn = jax.jit(lambda p, b, t, z: loss_fn(
            p, b, jax.random.PRNGKey(0), t=t, z=z))
        placed = j_shard_batch(mesh, jbatch, shard_grid=True)
        assert not placed["coords_6d"].sharding.is_fully_replicated
        want = float(fn(shard_params(mesh, params), placed,
                        put_array(jnp.asarray(t), batch_sharding(mesh)),
                        put_array(jnp.asarray(z), grid_sharding(mesh))))
    finally:
        jattn.set_backend(None)
    return {"cfg": cfg_dict, "sd": sd, "batch": jbatch, "t": t, "z": z,
            "loss": want}


@pytest.fixture(scope="module")
def train_batches():
    rng = np.random.default_rng(0)
    return [_batch(rng)]


@pytest.fixture(scope="module")
def plain_steps(train_batches):
    return _steps(_train_cfg(), train_batches)


@pytest.fixture(scope="module")
def gloo_run(jax_case, train_batches):
    """One run of 4 gloo ranks, data 2 x model 2, the pair grid's rows
    split over `model`: the JAX case's loss and a train step."""
    j = jax_case
    res = spawn(W.sequence_parallel, 4,
                args=((j["cfg"], j["sd"], 2, 2, j["batch"], j["t"], j["z"]),
                      (_train_cfg(), 2, 2, train_batches, SEED)),
                device="cpu", timeout=SPAWN_S)
    return res


def test_sp_loss_matches_jax_shard_grid(jax_case, gloo_run):
    """The mirror of the JAX test_sp_matches_dp_loss: the port's train loss
    with the rows split over `model`, the same weights (interop/from_jax)
    and injected t and z, on 4 gloo ranks (data 2 x model 2, every rank)
    and on a stacked group of 2 in one process, equals JAX's shard_grid
    loss on its data 4 x model 2 mesh to rtol 2e-4."""
    want = jax_case["loss"]
    for r in gloo_run:
        np.testing.assert_allclose(r["loss"], want, rtol=2e-4)
    cfg, state = W.build_state(jax_case["cfg"], state_dict=jax_case["sd"])
    sde, _ = get_sde(cfg)
    group = StackedRowGroup(2)
    loss_fn = get_sde_loss_fn(sde, state.model, train=True,
                              condition=tuple(cfg.model.condition),
                              row_group=group)
    z = torch.from_numpy(jax_case["z"])
    with rows_split(state.model, group):
        got = loss_fn(None, group.shard_batch(W.tensors(jax_case["batch"])),
                      t=group.tile(torch.from_numpy(jax_case["t"])),
                      z=group.local_rows(group.tile(z), 1))
    np.testing.assert_allclose(float(got.detach()), want, rtol=2e-4)


def test_sp_step_on_gloo_matches_the_plain_step(gloo_run, plain_steps):
    """One train step (dropout 0.1, random inpainting masks drawn on the
    device, the clip triggered) on 4 gloo ranks with the rows split over
    `model`, FSDP2 reducing the gradients, against the plain one-device
    step on the same batch and seed: every draw the same, so the loss and
    the gradient norm within rtol 1e-5, the gradients within 1e-4 and the
    updated params and EMA within 2e-4 of their scale, on every rank
    alike."""
    assert max(plain_steps["norms"]) > 1.0  # the clip acts
    got = gloo_run[0]["train"]
    _assert_steps_close(got, plain_steps)
    for other in gloo_run[1:]:
        assert other["train"]["losses"] == got["losses"]
        for k, v in got["params"].items():
            np.testing.assert_array_equal(other["train"]["params"][k], v)


@pytest.mark.parametrize("size", [2, 4])
def test_stacked_sp_step_matches_the_plain_step(plain_steps, train_batches,
                                                size):
    """The same step with the rows split over a stacked group of 2 or
    4 ranks in one process (at 4 the 8 x 8 attention runs 16 query tokens
    a rank): the plain step's loss, norm, gradients, params and EMA
    (tolerances of the gloo test)."""
    got = _steps(_train_cfg(), train_batches, StackedRowGroup(size))
    _assert_steps_close(got, plain_steps)


def _records_batches(tmp_path, cfg_dict, n_batches=1, b=B, lengths=None,
                     **records):
    """Batches of `b` helix records (lengths 9 to N by default) as
    `data.featurize_on_device` ships them (backbones; for C=8 the SS block
    channels)."""
    from text2protein_tpu_torch.conditioning import batch_to_device_arrays
    from text2protein_tpu_torch.config import load_config
    from text2protein_tpu_torch.data.dataset import (
        ProteinProcessedDataset,
        make_batch,
    )
    from text2protein_tpu_torch.data.helix_records import write_records
    from text2protein_tpu_torch.text.encoder import build_text_encoder

    cfg = load_config(cfg_dict)
    n = cfg.data.max_res_num
    write_records(tmp_path, b * n_batches, lengths=lengths or (9, n),
                  **records)
    ds = ProteinProcessedDataset(tmp_path)
    encoder = build_text_encoder(cfg)
    out = []
    for i in range(n_batches):
        host = make_batch([ds[j] for j in range(b * i, b * i + b)], n)
        arrays = batch_to_device_arrays(host, cfg)
        arrays["context"], arrays["context_mask"] = encoder.encode(
            host["caption"])
        out.append(W.tensors(arrays))
    return out


SETTINGS = {
    # configs/quality_ss.yml's family: C=8, length + ss + inpainting, the
    # SS block dropout and the inpainting masks drawn on the device
    "ss_inpainting_c8": (
        dict(condition=["length", "ss", "inpainting"]),
        {"num_channels": 8}, 1e-5, 1e-4, 2e-4),
    # configs/quality_n256.yml's settings: bf16 (the GroupNorms too), remat
    # of the residual blocks. The split rows sum in another order (the halo
    # convolutions, GroupNorm, the gathered attention), and bf16 rounds
    # each op: held within about the bf16 step's own distance from the f32
    # step at these inputs (measured on the CPU: loss 2.5e-4, norm 1.4e-3,
    # gradients 0.12 and params 4.9e-3 of their scale; the split rows:
    # loss 0, norm 1.8e-4, gradients 4.3e-2, params 4.5e-3)
    "bf16_remat": (
        dict(condition=["length"], dtype="bfloat16", norm_dtype="bfloat16",
             remat_resblocks=True),
        {}, 2e-3, 1e-1, 1e-2),
}


@pytest.mark.parametrize("name", list(SETTINGS))
def test_stacked_sp_step_with_featurization_on_the_device(tmp_path, name):
    """A train step with featurization on the device (the whole grid
    built from the backbones, each rank's rows kept) and dropout 0.1,
    the rows split over a stacked group of 2, against the plain step:
    the SS + inpainting C=8 family in f32 within the gloo test's
    tolerances; bf16 + remat: loss and norm within rtol 2e-3, gradients
    within 1e-1 and params and EMA within 1e-2 of their scale (SETTINGS
    says why)."""
    model, data, loss_rtol, grad_tol, tol = SETTINGS[name]
    cfg = _train_cfg(**model)
    cfg["data"].update(featurize_on_device=True, **data)
    batches = _records_batches(tmp_path, cfg,
                               num_channels=data.get("num_channels", 5))
    plain = _steps(cfg, batches)
    got = _steps(cfg, batches, StackedRowGroup(2))
    _assert_steps_close(got, plain, loss_rtol, grad_tol, tol)


def test_stacked_sp_step_at_the_n256_models_depth(tmp_path):
    """configs/quality_n256.yml as written but narrow (nf 8, one residual
    block a level, 2 heads, a 32-wide caption, batch 1): its 6 levels down
    to an 8 x 8 grid that `model` 2 splits into 4 rows a rank, attention
    at 32, 16 and 8, bf16 with remat of the residual and transformer
    blocks, featurization on the device, dropout 0.1. The stacked 2-rank
    step against the plain step within the bf16 + remat tolerances of
    SETTINGS."""
    import yaml

    cfg = yaml.safe_load((REPO / "configs" / "quality_n256.yml").read_text())
    cfg["model"].update(nf=8, num_res_blocks=1, n_heads=2,
                        context_dim=CONTEXT_DIM)
    cfg["optim"].update(warmup=0, lr=LR)
    cfg["training"]["batch_size"] = 1
    assert cfg["data"]["max_res_num"] == 256
    assert len(cfg["model"]["ch_mult"]) == 6
    batches = _records_batches(tmp_path, cfg, b=1, lengths=(128, 256))
    plain = _steps(cfg, batches)
    got = _steps(cfg, batches, StackedRowGroup(2))
    _assert_steps_close(got, plain, *SETTINGS["bf16_remat"][2:])
