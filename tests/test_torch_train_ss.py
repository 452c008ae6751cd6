"""The SS + inpainting model family (configs/quality_ss.yml's conditions,
C=8) in the port against the JAX package, on the CPU at tiny widths: the
DSM loss and its gradients with injected draws, the trainer with
featurization on the device, resume and snapshot sampling, the sampling
CLI from a PDB with an inpainting mask, and every C=8 / inpainting yml
building and taking a train step.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental import pallas as pl

import text2protein_tpu.ops.attention as jattn
import text2protein_tpu.ops.flash as jflash
from text2protein_tpu import conditioning as jcond
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.diffusion.losses import (
    get_sde_loss_fn as j_get_sde_loss_fn,
)
from text2protein_tpu.diffusion.sde import get_sde as j_get_sde
from text2protein_tpu.models import build_model as j_build_model
from text2protein_tpu_torch import conditioning as tcond
from text2protein_tpu_torch.cli import sampling_6d
from text2protein_tpu_torch.cli import train as ttrain
from text2protein_tpu_torch.config import CONFIGS, load_config
from text2protein_tpu_torch.data.dataset import ProteinProcessedDataset
from text2protein_tpu_torch.data.helix_records import write_records
from text2protein_tpu_torch.data.pdbio import write_backbone_pdb
from text2protein_tpu_torch.diffusion.losses import get_sde_loss_fn
from text2protein_tpu_torch.diffusion.sde import get_sde
from text2protein_tpu_torch.interop.from_jax import (
    state_dict_from_flax_params,
)
from text2protein_tpu_torch.models.unet import build_model

from torch_port_helpers import (  # noqa: F401  (a fixture)
    CONTEXT_DIM,
    N,
    flax_template,
    one_torch_thread,
    random_flax_params,
    tiny_config_dict,
)

C8 = 8
CONDITION = ["length", "ss", "inpainting"]


def _ss_cfgd(**over):
    cfg = tiny_config_dict(condition=CONDITION)
    cfg["data"]["num_channels"] = C8
    for section, values in over.items():
        cfg.setdefault(section, {}).update(values)
    return cfg


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


def _batch(seed, t_ctx=64, b=2):
    """An NHWC C=8 batch: random maps with 0/1 SS channels and the length
    mask last, SS block spans, a random inpainting mask and a caption of
    t_ctx tokens with a padded row."""
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1, 1, (b, N, N, C8)).astype(np.float32)
    coords[..., 4:7] = rng.uniform(size=(b, N, N, 3)) < 0.3
    lengths = np.array([11, N][:b])
    row = np.arange(N)[None, :] < lengths[:, None]
    mask_pair = row[:, :, None] & row[:, None, :]
    coords[..., -1] = mask_pair
    spans = np.full((b, 32, 2), -1, np.int32)
    spans[0, :2] = [[1, 5], [6, 10]]
    spans[1, :3] = [[0, 4], [5, 9], [11, 15]]
    ctx_mask = np.ones((b, t_ctx), bool)
    ctx_mask[0, t_ctx // 2:] = False
    inpaint = rng.uniform(size=(b, N)) < 0.4
    batch = {
        "coords_6d": coords * mask_pair[..., None],
        "mask_pair": mask_pair,
        "ss_spans": spans,
        "length": lengths.astype(np.int32),
        "mask_inpaint": inpaint[:, :, None] | inpaint[:, None, :],
        "context": rng.standard_normal((b, t_ctx, CONTEXT_DIM)
                                       ).astype(np.float32),
        "context_mask": ctx_mask,
    }
    t = rng.uniform(1e-5, 1.0, b).astype(np.float32)
    z = rng.standard_normal((b, N, N, C8)).astype(np.float32)
    return batch, t, z


@pytest.fixture(scope="module")
def tiny_ss_models():
    cfg = _ss_cfgd()
    jmodel = j_build_model(j_load_config(cfg))
    batch, _, _ = _batch(0)
    template = flax_template(jmodel, batch["coords_6d"], np.zeros(2),
                             batch["context"], batch["context_mask"])
    params = random_flax_params(template, 5)
    tcfg = load_config(cfg)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax_params(params, tcfg),
                           strict=True)
    return cfg, jmodel, params, tmodel


def test_ss_inpainting_loss_and_gradients_match_jax(jax_pallas,
                                                    tiny_ss_models):
    """The C=8 train loss with the conditions length + ss + inpainting,
    dropout 0: injected t, z and mask_inpaint, and the JAX loss's SS block
    dropout draw (its key's split) injected as `ss_drop`. The loss within
    rtol 2e-4 (the DSM loss bar); every gradient within a max diff of 1e-3
    of its own max abs, floored at 1e-3 of the model's largest (as in
    test_torch_train.py)."""
    cfg, jmodel, params, tmodel = tiny_ss_models
    batch, t, z = _batch(7)
    key = jax.random.PRNGKey(3)
    k_drop = jax.random.split(key, 6)[1]
    drop = np.array(jax.random.uniform(k_drop, (2, 32)) < 0.2)
    # the draw drops some real block, so the SS dropout path is live
    assert (drop & (batch["ss_spans"][..., 0] >= 0)).any()
    jsde, _ = j_get_sde(j_load_config(cfg))
    tsde, _ = get_sde(load_config(cfg))
    jloss = j_get_sde_loss_fn(jsde, jmodel, train=True, condition=CONDITION)
    want_loss, jgrads = jax.value_and_grad(jloss)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        t=jnp.asarray(t), z=jnp.asarray(z))
    want = state_dict_from_flax_params(
        jax.tree_util.tree_map(np.array, jgrads), load_config(cfg))

    tloss = get_sde_loss_fn(tsde, tmodel, train=True, condition=CONDITION)
    tmodel.zero_grad(set_to_none=True)
    loss = tloss(None, {k: torch.from_numpy(np.array(v))
                        for k, v in batch.items()},
                 t=torch.from_numpy(t), z=torch.from_numpy(z),
                 ss_drop=torch.from_numpy(drop))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-4)
    got = {k: p.grad.numpy() for k, p in tmodel.named_parameters()}
    floor = 1e-3 * max(np.abs(w.numpy()).max() for w in want.values())
    worst = max((float(np.abs(got[k] - w.numpy()).max()
                       / max(np.abs(w.numpy()).max(), floor)), k)
                for k, w in want.items())
    assert worst[0] < 1e-3, worst
    tmodel.zero_grad(set_to_none=True)


# ------------------------------------------------------------ the trainer


def _write(tmp_path, **over):
    cfg = _ss_cfgd(
        training={"batch_size": 2, "log_freq": 1, **over.pop("training",
                                                              {})},
        data={"featurize_on_device": True, "min_res_num": 4},
        optim={"warmup": 2}, **over)
    cfg["model"]["dropout"] = 0.1
    path = tmp_path / "ss_tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def _train(tmp_path, cfg_path, steps, *extra):
    return ttrain.main(["--config", str(cfg_path), "--data",
                        str(tmp_path / "rec"), "--max_steps", str(steps),
                        "--device", "cpu", *extra])


@pytest.mark.usefixtures("one_torch_thread")
def test_ss_trainer_resumes_bit_for_bit(tmp_path):
    """C=8 helix records, featurization on the device, length + ss +
    inpainting: four steps straight, and two then --resume to four, give
    the same losses and the same parameters, EMA and Adam state, bit for
    bit (the step's inpainting masks come from their own stream)."""
    write_records(tmp_path / "rec", 9, lengths=(9, 16), num_channels=8)
    cfg_path = _write(tmp_path, training={"eval_freq": 2,
                                          "snapshot_freq_for_preemption": 3})
    straight = _train(tmp_path, cfg_path, 4, "--workdir_root",
                      str(tmp_path / "a"))
    assert np.isfinite(straight["losses"]).all()
    first = _train(tmp_path, cfg_path, 2, "--workdir_root",
                   str(tmp_path / "b"))
    again = _train(tmp_path, cfg_path, 4, "--resume", str(first["workdir"]))
    assert again["losses"] == straight["losses"][2:]
    a, b = again["state"], straight["state"]
    assert a.step == b.step == 4
    for k, p in a.model.named_parameters():
        assert torch.equal(p, dict(b.model.named_parameters())[k]), k
        assert torch.equal(a.ema.params[k], b.ema.params[k]), k
    sa, sb = a.optimizer.adam.state_dict(), b.optimizer.adam.state_dict()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)


@pytest.fixture(scope="module")
def ss_run(tmp_path_factory):
    """The tiny SS config trained 3 steps with snapshot sampling and an
    eval boundary at every step. Three records split 2 / 1, so an epoch is
    one step of batch 2 and each boundary falls in an epoch of its own:
    (tmp dir, config path, result)."""
    tmp = tmp_path_factory.mktemp("ss")
    write_records(tmp / "rec", 3, lengths=(12, 16), num_channels=8)
    path = _write(tmp, training={"snapshot_sampling": True,
                                 "eval_freq": 1},
                  model={"num_scales": 20})
    res = _train(tmp, path, 3, "--workdir_root", str(tmp / "runs"))
    return tmp, path, res


@pytest.mark.usefixtures("one_torch_thread")
def test_snapshot_sampling_writes_one_conditioned_sample(ss_run):
    """One (B, 8, N, N) sample of the EMA params at each of the three eval
    boundaries (the sampler built once and reused): each finite, its SS
    channels the eval batch's 0/1 maps and its last channel a length mask
    (the conditions clamped)."""
    tmp, _, res = ss_run
    assert [e[0] for e in res["evals"]] == [1, 2, 3]
    files = sorted((res["workdir"] / "samples").rglob("*.pkl"))
    assert [p.relative_to(res["workdir"]).as_posix() for p in files] == [
        f"samples/epoch_{e}/sample.pkl" for e in (1, 2, 3)]
    for path in files:
        with open(path, "rb") as f:
            sample = pickle.load(f)
        assert sample.shape == (2, C8, N, N) and sample.dtype == np.float32
        assert np.isfinite(sample).all()
        assert set(np.unique(sample[:, 4:7])) <= {0.0, 1.0}
        for m in sample[:, -1]:
            L = int(m[0].sum())
            want = np.zeros((N, N), np.float32)
            want[:L, :L] = 1
            np.testing.assert_array_equal(m, want)


@pytest.mark.usefixtures("one_torch_thread")
def test_conditions_from_pdb_match_jax_and_sampling_cli_clamps(ss_run):
    """A PDB written from a C=8 record: get_conditions_from_pdb with
    mask_info equals the JAX package's (length and SS exactly, the
    inpainting maps within 1e-6 and its mask exactly); cli/sampling_6d
    --pdb --mask_info --device cpu then writes (1, 8, N, N) pickles whose
    SS channels are the PDB's exactly, whose every entry outside the
    inpainting region is the condition's exactly, and whose last channel
    is the length mask."""
    tmp, cfg_path, res = ss_run
    rec = ProteinProcessedDataset(tmp / "rec")[0]
    pdb = tmp / "ss_chain.pdb"
    write_backbone_pdb(pdb, rec["coords"], seq=rec["aa_str"])
    spec = "1:5,10:12"
    tcfg = load_config(str(cfg_path))
    jcfg = j_load_config(yaml.safe_load(cfg_path.read_text()))
    want = jcond.get_conditions_from_pdb(str(pdb), jcfg, mask_info=spec,
                                         batch_size=3)
    got = tcond.get_conditions_from_pdb(str(pdb), tcfg, mask_info=spec,
                                        batch_size=3)
    assert set(got) == set(want) == set(CONDITION)
    np.testing.assert_array_equal(got["length"].numpy(),
                                  np.asarray(want["length"]))
    np.testing.assert_array_equal(got["ss"].numpy(), np.asarray(want["ss"]))
    assert got["ss"].any()
    np.testing.assert_allclose(got["inpainting"]["coords_6d"].numpy(),
                               np.asarray(want["inpainting"]["coords_6d"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(
        got["inpainting"]["mask_inpaint"].numpy(),
        np.asarray(want["inpainting"]["mask_inpaint"]))

    out = sampling_6d.main([
        str(cfg_path), str(res["workdir"] / "checkpoints" / "best_eval.pt"),
        "--pdb", str(pdb), "--chain", "A", "--mask_info", spec,
        "--sampler", "pc", "--num_steps", "3", "--batch_size", "2",
        "--device", "cpu", "--workdir_root", str(tmp / "sampling")])
    pickles = sorted(out["workdir"].glob("*.pkl"))
    assert len(pickles) == 2
    cond = got["inpainting"]["coords_6d"][0].numpy()
    free = got["inpainting"]["mask_inpaint"][0].numpy()
    for p in pickles:
        with open(p, "rb") as f:
            a = pickle.load(f)
        assert a.shape == (1, C8, N, N) and np.isfinite(a).all()
        x = a[0].transpose(1, 2, 0)
        np.testing.assert_array_equal(x[..., 4:7], got["ss"][0].numpy())
        np.testing.assert_array_equal(x[..., -1],
                                      got["length"][0].numpy())
        np.testing.assert_array_equal(x[~free], cond[~free])


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("yml", ["quality_ss", "quality_ss_vp", "cond_ss",
                                 "cond_ss_inpainting",
                                 "cond_length_inpainting", "no_cond"])
def test_every_c8_or_inpainting_yml_takes_a_train_step(tmp_path, yml):
    """Each yml as written but for tiny widths (nf 32, two levels,
    attention at 8, context 64, batch 2) and N=16: the trainer builds it
    (dtype, featurization and conditions its own) and takes a finite train
    step on C=8 helix records."""
    cfg = yaml.safe_load((CONFIGS / f"{yml}.yml").read_text())
    nc = cfg["data"]["num_channels"]
    write_records(tmp_path / "rec", 5, lengths=(12, 16), num_channels=nc)
    cfg["data"].update(max_res_num=N, min_res_num=4)
    cfg["model"].update(nf=32, ch_mult=[1, 2], num_res_blocks=1,
                        attn_resolutions=[8], n_heads=4, context_dim=64,
                        num_scales=20)
    cfg["training"].update(batch_size=2, snapshot_sampling=False)
    cfg["text"].update(pad_to_bucket=8, max_tokens=8)
    path = tmp_path / f"{yml}.yml"
    path.write_text(yaml.safe_dump(cfg))
    res = ttrain.main(["--config", str(path), "--data", str(tmp_path / "rec"),
                       "--max_steps", "1", "--device", "cpu",
                       "--workdir_root", str(tmp_path / "runs")])
    assert len(res["losses"]) == 1 and np.isfinite(res["losses"]).all()
    assert np.isfinite(res["eval_loss"])
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        cfg["model"].get("dtype", "float32")]
    assert res["state"].model.dtype == dtype
