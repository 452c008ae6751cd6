"""The port's training slice against the JAX package, on the CPU.

Tiny config of torch_port_helpers with random weights (proj_out included)
carried across with `state_dict_from_flax_params`; the same numpy inputs
and the same injected draws (t, z, dropout masks) go to both packages; f32.
The JAX model takes its Pallas attention kernels in interpret mode
(`set_backend("pallas")`), as the port's CPU path takes their plain
versions: a 64-token caption takes the backward kernel route in both, an
8-token caption the einsum-recompute fallback. Tolerances are stated per
test; the DSM loss bar is rtol 2e-4 (MIGRATION.md).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

import text2protein_tpu.ops.attention as jattn
import text2protein_tpu.ops.flash as jflash
from text2protein_tpu.conditioning import (
    batch_to_device_arrays as j_batch_to_device_arrays,
)
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.data.dataset import ProteinProcessedDataset as JDataset
from text2protein_tpu.data.dataset import make_batch as j_make_batch
from text2protein_tpu.data.featurize import (
    featurize_structure as j_featurize_structure,
)
from text2protein_tpu.diffusion.ema import ema_init as j_ema_init
from text2protein_tpu.diffusion.ema import ema_update as j_ema_update
from text2protein_tpu.diffusion.losses import block_dropout as j_block_dropout
from text2protein_tpu.diffusion.losses import (
    get_sde_loss_fn as j_get_sde_loss_fn,
)
from text2protein_tpu.diffusion.losses import (
    make_conditional_mask as j_make_conditional_mask,
)
from text2protein_tpu.diffusion.sde import get_sde as j_get_sde
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu.training.state import build_optimizer as j_build_opt
from text2protein_tpu_torch.cli import train as ttrain
from text2protein_tpu_torch.cli.serve import Server, decode_coords
from text2protein_tpu_torch.conditioning import batch_to_device_arrays
from text2protein_tpu_torch.config import bench_l128_config, load_config
from text2protein_tpu_torch.data.dataset import (
    ProteinProcessedDataset,
    load_record,
    make_batch,
)
from text2protein_tpu_torch.data.featurize import featurize_structure
from text2protein_tpu_torch.data.helix_records import (
    helix_backbone,
    write_records,
)
from text2protein_tpu_torch.diffusion.ema import ema_init, ema_update
from text2protein_tpu_torch.diffusion.losses import (
    block_dropout,
    get_sde_loss_fn,
    make_conditional_mask,
)
from text2protein_tpu_torch.diffusion.sde import get_sde
from text2protein_tpu_torch.interop.from_jax import (
    state_dict_from_flax_params,
)
from text2protein_tpu_torch.models.layers import Dropout
from text2protein_tpu_torch.models.unet import build_model
from text2protein_tpu_torch.ops import flash as tflash
from text2protein_tpu_torch.training.state import Optimizer
from text2protein_tpu_torch.training.steps import step_generator

from torch_port_helpers import (
    C,
    CONTEXT_DIM,
    N,
    flax_template,
    random_flax_params,
    tiny_config_dict,
)

REPO_DATA = "data/processed_synth"


@pytest.fixture()
def jax_pallas(monkeypatch):
    """The JAX package's attention through its Pallas kernels, interpreted
    on the CPU."""
    orig = pl.pallas_call
    monkeypatch.setattr(
        jflash.pl, "pallas_call", functools.partial(orig, interpret=True))
    monkeypatch.setattr(
        jflash, "flash_attention_fwd", jflash.flash_attention_fwd.__wrapped__)
    monkeypatch.setattr(
        jflash, "flash_attention_bwd", jflash.flash_attention_bwd.__wrapped__)
    jattn.set_backend("pallas")
    yield
    jattn.set_backend(None)


def _batch(seed, t_ctx, condition=("length",), b=2):
    """NHWC numpy batch: random maps, length masks, a caption embedding of
    t_ctx tokens with a padded mask (every row keeps a live token)."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (b, N, N, C)).astype(np.float32)
    lengths = np.array([11, N][:b])
    row = np.arange(N)[None, :] < lengths[:, None]
    mask_pair = row[:, :, None] & row[:, None, :]
    coords[..., -1] = mask_pair
    ctx_mask = np.ones((b, t_ctx), bool)
    ctx_mask[0, t_ctx // 2:] = False
    batch = {
        "coords_6d": coords * mask_pair[..., None],
        "mask_pair": mask_pair,
        "context": rng.standard_normal((b, t_ctx, CONTEXT_DIM)
                                       ).astype(np.float32),
        "context_mask": ctx_mask,
        "ss_spans": np.full((b, 32, 2), -1, np.int32),
    }
    t = rng.uniform(1e-5, 1.0, b).astype(np.float32)
    z = rng.standard_normal((b, N, N, C)).astype(np.float32)
    return batch, t, z


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def tiny_models():
    """(config dict, jax model, flax params, port model) with the same
    random weights."""
    cfg = tiny_config_dict()
    jmodel = j_build_model(j_load_config(cfg))
    batch, _, _ = _batch(0, 8)
    template = flax_template(jmodel, batch["coords_6d"], np.zeros(2),
                             batch["context"], batch["context_mask"])
    params = random_flax_params(template, 3)
    tcfg = load_config(cfg)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax_params(params, tcfg),
                           strict=True)
    return cfg, jmodel, params, tmodel


# ---------------------------------------------------------------- masks


@pytest.mark.parametrize("condition", [(), ("length",), ("ss",),
                                       ("length", "inpainting")])
def test_make_conditional_mask_matches_jax(condition):
    rng = np.random.default_rng(1)
    coords = rng.standard_normal((2, N, N, 8)).astype(np.float32)
    inpaint = rng.uniform(size=(2, N, N)) < 0.5
    want = j_make_conditional_mask(jnp.asarray(coords), condition,
                                   jnp.asarray(inpaint))
    got = make_conditional_mask(torch.from_numpy(coords), condition,
                                torch.from_numpy(inpaint))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_block_dropout_matches_jax_with_injected_mask():
    """The drop draw of the JAX function, recomputed from its key, injected
    into the port's: equal outputs (exact; it is a masked multiply)."""
    rng = np.random.default_rng(2)
    coords = rng.standard_normal((3, N, N, 8)).astype(np.float32)
    spans = np.full((3, 32, 2), -1, np.int32)
    spans[0, :3] = [[0, 4], [6, 9], [12, 16]]
    spans[1, :2] = [[2, 8], [9, 15]]
    spans[2, :1] = [[1, 5]]
    key = jax.random.PRNGKey(5)
    want = j_block_dropout(key, jnp.asarray(coords), jnp.asarray(spans),
                           p=0.5)
    drop = np.asarray(jax.random.uniform(key, (3, 32)) < 0.5)
    assert drop[:, :3][spans[:, :3, 0] >= 0].any()
    got = block_dropout(torch.from_numpy(coords), torch.from_numpy(spans),
                        p=0.5, drop=torch.from_numpy(np.array(drop)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- loss


@pytest.mark.parametrize("t_ctx", [64, 8], ids=["kernel_route", "fallback"])
@pytest.mark.parametrize("train", [False, True])
def test_dsm_loss_matches_jax(jax_pallas, tiny_models, t_ctx, train):
    """Injected t and z; dropout 0: rtol 2e-4 (the DSM loss bar)."""
    cfg, jmodel, params, tmodel = tiny_models
    batch, t, z = _batch(4, t_ctx)
    jsde, _ = j_get_sde(j_load_config(cfg))
    tsde, _ = get_sde(load_config(cfg))
    jloss = j_get_sde_loss_fn(jsde, jmodel, train=train,
                              condition=("length",))
    tloss = get_sde_loss_fn(tsde, tmodel, train=train, condition=("length",))
    want = jloss(params, _to_jax(batch), jax.random.PRNGKey(0),
                 t=jnp.asarray(t), z=jnp.asarray(z))
    with torch.no_grad():
        got = tloss(None, _to_torch(batch), t=torch.from_numpy(t),
                    z=torch.from_numpy(z))
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-4)


def _rel(got, want, floor):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), floor))


@pytest.mark.parametrize("t_ctx", [64, 8], ids=["kernel_route", "fallback"])
def test_param_gradients_match_jax_grad(jax_pallas, tiny_models, t_ctx):
    """jax.grad of the train loss (dropout 0) mapped through
    state_dict_from_flax_params, key by key against the port's .grad: the
    loss within rtol 2e-4 and every gradient within a max diff of 1e-3 of
    its own max abs (f32 through ~60 layers of backward, sums in other
    orders). The scale has a floor of 1e-3 of the largest gradient of the
    model: the attention key biases (NIN_1.b) have a gradient of 0 in exact
    arithmetic (softmax ignores a shift of a whole row), so both packages
    give rounding noise there."""
    cfg, jmodel, params, tmodel = tiny_models
    batch, t, z = _batch(6, t_ctx)
    jsde, _ = j_get_sde(j_load_config(cfg))
    tsde, _ = get_sde(load_config(cfg))
    jloss = j_get_sde_loss_fn(jsde, jmodel, train=True,
                              condition=("length",))
    want_loss, jgrads = jax.value_and_grad(jloss)(
        params, _to_jax(batch), jax.random.PRNGKey(0), t=jnp.asarray(t),
        z=jnp.asarray(z))
    want = state_dict_from_flax_params(
        jax.tree_util.tree_map(np.array, jgrads), load_config(cfg))

    tloss = get_sde_loss_fn(tsde, tmodel, train=True, condition=("length",))
    tmodel.zero_grad(set_to_none=True)
    loss = tloss(None, _to_torch(batch), t=torch.from_numpy(t),
                 z=torch.from_numpy(z))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-4)
    got = {k: p.grad for k, p in tmodel.named_parameters()}
    assert set(got) == set(want)
    floor = 1e-3 * max(np.abs(w.numpy()).max() for w in want.values())
    worst = max((_rel(got[k].numpy(), want[k].numpy(), floor), k)
                for k in want)
    assert worst[0] < 1e-3, worst
    tmodel.zero_grad(set_to_none=True)


# ------------------------------------------------------ optimizer + EMA


def _opt_config(warmup, clip=1.0, weight_decay=0):
    return {"optim": {"optimizer": "Adam", "lr": 1e-2, "beta1": 0.9,
                      "eps": 1e-8, "warmup": warmup, "grad_clip": clip,
                      "weight_decay": weight_decay},
            "model": {"ema_rate": 0.999}}


@pytest.mark.parametrize("warmup,grad_scale,weight_decay", [
    (0, 0.01, 0),     # below the clip, no warmup
    (0, 10.0, 0),     # global norm above the clip
    (3, 10.0, 0),     # warmup: the first update runs at lr 0
    (3, 0.01, 0.1),   # AdamW
])
def test_clip_adam_ema_steps_match_optax(warmup, grad_scale, weight_decay):
    """Three updates of clip -> Adam -> EMA against the JAX package's optax
    chain and `ema_update`: params and EMA within atol/rtol 1e-6."""
    cfg = _opt_config(warmup, weight_decay=weight_decay)
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 5), "b": (7,), "c": (3, 2, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]

    tx = j_build_opt(j_load_config(cfg))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jopt = tx.init(jp)
    jema = j_ema_init(jp, 0.999)

    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in p0.items()}
    opt = Optimizer(load_config(cfg), tparams.values())
    tema = ema_init(tparams, 0.999)
    for i, g in enumerate(grads):
        updates, jopt = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jopt, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        jema = j_ema_update(jema, jp)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        ema_update(tema, tparams)
        for k in shapes:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6,
                                       rtol=1e-6)
            np.testing.assert_allclose(tema.params[k].numpy(),
                                       np.asarray(jema.params[k]), atol=1e-6,
                                       rtol=1e-6)
        if i == 0 and warmup:
            for k in shapes:  # lr 0 at count 0
                assert torch.equal(tparams[k].detach(),
                                   torch.from_numpy(p0[k]))
    assert tema.num_updates == int(jema.num_updates) == 3


def test_clip_matches_optax_rule():
    """Above the clip: (g / norm) * max_norm, no epsilon; below: as is."""
    rng = np.random.default_rng(8)
    for scale in (0.01, 10.0):
        g = {"a": (rng.standard_normal((5, 3)) * scale).astype(np.float32)}
        want, _ = optax.clip_by_global_norm(1.0).update(
            {"a": jnp.asarray(g["a"])}, None)
        p = torch.nn.Parameter(torch.zeros(5, 3))
        opt = Optimizer(load_config(_opt_config(0)), [p])
        p.grad = torch.from_numpy(g["a"].copy())
        from text2protein_tpu_torch.training.state import clip_by_global_norm

        clip_by_global_norm([p.grad], 1.0)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want["a"]),
                                   rtol=1e-6, atol=0)
        del opt


# ---------------------------------------------------------------- dropout


def test_dropout_keeps_one_minus_p_and_scales():
    d = Dropout(0.25).train()
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y = d(x, gen)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.005
    assert torch.allclose(y[y != 0], torch.full_like(y[y != 0], 1 / 0.75))
    # repeatable from a generator, different from another seed
    y2 = d(x, torch.Generator().manual_seed(0))
    y3 = d(x, torch.Generator().manual_seed(1))
    assert torch.equal(y, y2) and not torch.equal(y, y3)
    # identity in eval mode or at p = 0; a train-mode draw needs a generator
    assert torch.equal(d.eval()(x), x)
    assert torch.equal(Dropout(0.0).train()(x), x)
    with pytest.raises(ValueError, match="Generator"):
        d.train()(x)


def test_train_mode_dropout_is_drawn_from_the_step_generator(tiny_models):
    """With dropout on, the model's output depends only on the generator:
    the same (seed, step) gives the same loss, another step another one."""
    cfg = tiny_config_dict(dropout=0.3)
    tcfg = load_config(cfg)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(tiny_models[3].state_dict())
    tsde, _ = get_sde(tcfg)
    loss_fn = get_sde_loss_fn(tsde, model, train=True, condition=("length",))
    batch = _to_torch(_batch(9, 8)[0])
    with torch.no_grad():
        a = loss_fn(None, batch, step_generator(42, 3, "cpu"))
        b = loss_fn(None, batch, step_generator(42, 3, "cpu"))
        c = loss_fn(None, batch, step_generator(42, 4, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------- data


def test_make_batch_and_device_arrays_match_jax():
    """Four committed records through both packages' collate and batch
    preparation: equal arrays."""
    jds, tds = JDataset(REPO_DATA), ProteinProcessedDataset(REPO_DATA)
    assert jds.data_paths[:4] == tds.data_paths[:4]
    recs = [tds[i] for i in range(4)]
    jrecs = [jds[i] for i in range(4)]
    want, got = j_make_batch(jrecs, 64), make_batch(recs, 64)
    assert set(got) == set(want)
    for k in got:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    cfg = j_load_config({"data": {"max_res_num": 64},
                         "model": {"condition": ["length"]}})
    jarr = j_batch_to_device_arrays(want, cfg, device=False)
    tarr = batch_to_device_arrays(got, load_config(
        {"data": {"max_res_num": 64}, "model": {"condition": ["length"]}}))
    assert set(tarr) == set(jarr)
    for k in tarr:
        np.testing.assert_array_equal(tarr[k].numpy(), np.asarray(jarr[k]),
                                      err_msg=k)
    # the inpainting condition: the same arrays; the train and eval steps
    # draw the masks on the device (test_torch_inpainting_masks.py)
    icfg = load_config({"data": {"max_res_num": 64},
                        "model": {"condition": ["inpainting"]}})
    assert set(batch_to_device_arrays(got, icfg)) == set(jarr)


def test_featurize_structure_matches_jax(tmp_path):
    """The C=5 host featurization of a helix backbone with a masked residue,
    and its npz record round trip."""
    bb = helix_backbone(np.random.default_rng(3), 20)
    mask = np.ones(20)
    mask[7] = 0
    want = j_featurize_structure(bb, mask, False)
    got = featurize_structure(bb, mask, False)
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] == ""
    write_records(tmp_path, 2, lengths=(12, 16))
    rec = load_record(tmp_path / "smoke_001.npz")
    assert rec["coords_6d"].shape[0] == 5 and rec["caption"]


def test_bench_l128_config_matches_the_yml():
    """bench_l128_config() has the yml's values for every key the port
    reads (the yml's bf16 norm_dtype is not ported)."""
    want = j_load_config("configs/bench_l128.yml")
    got = bench_l128_config()
    for section in ("training", "data", "model", "optim", "text"):
        for k, v in got[section].items():
            if k == "processed_dataset_path":
                continue
            assert want[section][k] == v, (section, k)
    assert got.seed == want.seed


# ---------------------------------------------------------------- CLI


def test_train_cli_two_steps_then_serve(tmp_path):
    """cli/train.main on the tiny config for 2 steps on the CPU: finite
    losses, the first step at lr 0, no kernel launch counted, and EMA
    weights that the Server loads (strict) and serves from."""
    import yaml

    write_records(tmp_path, 6, lengths=(9, 16))
    cfg = tiny_config_dict(dropout=0.1)
    cfg["training"].update({"batch_size": 2, "log_freq": 1})
    cfg["optim"] = {"warmup": 2}
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))
    out = tmp_path / "ema.pt"
    before = (tflash.flash_attention_fwd.launches,
              tflash.flash_attention_bwd.launches)
    res = ttrain.main(["--config", str(tmp_path / "cfg.yml"), "--data",
                       str(tmp_path), "--max_steps", "2", "--device", "cpu",
                       "--out", str(out), "--workdir_root",
                       str(tmp_path / "runs")])
    assert (tflash.flash_attention_fwd.launches,
            tflash.flash_attention_bwd.launches) == before
    assert res["steps"] == 2 and len(res["losses"]) == 2
    assert np.isfinite(res["losses"]).all() and np.isfinite(res["eval_loss"])
    assert res["lrs"] == [0.0, 1e-4 / 2]
    state = res["state"]
    assert state.ema.num_updates == 2
    server = Server(load_config(cfg), batch_size=2, num_steps=3,
                    weights=str(out), device="cpu")
    ema = torch.load(out, weights_only=True)
    for k, v in server.model.state_dict().items():
        assert torch.equal(v, ema[k])
    reply = server.run_batch([{"caption": "helix", "length": 12}])
    cnn = decode_coords(reply[0])
    assert cnn.shape == (C, N, N) and np.isfinite(cnn).all()


def test_split_dataset_matches_jax():
    from text2protein_tpu.cli.train import split_dataset as j_split

    for n, seed in ((32, 42), (384, 0), (2, 7)):
        for a, b in zip(ttrain.split_dataset(n, seed), j_split(n, seed)):
            np.testing.assert_array_equal(a, b)
