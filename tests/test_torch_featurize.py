"""On-device featurization (`data.featurize_on_device`) in the port, on the
CPU.

`data.featurize.featurize_batch` on seeded backbones with padded residues
against the JAX package's `featurize_batch_jax` (atol 1e-5, no NaN: the
padded residues' NaNs are cut by a `where`); a trainer batch shipped as
backbones and featurized in the step against the same records featurized
on the host; and `cli/train.py` with the N=256 settings (bf16, remat,
featurize on device) at the tiny widths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from text2protein_tpu.data.featurize import featurize_batch_jax
from text2protein_tpu_torch.cli import train as ttrain
from text2protein_tpu_torch.conditioning import batch_to_device_arrays
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.data.dataset import (
    ProteinProcessedDataset,
    make_batch,
)
from text2protein_tpu_torch.data.featurize import featurize_batch
from text2protein_tpu_torch.data.helix_records import (
    helix_backbone,
    write_records,
)
from text2protein_tpu_torch.training.steps import featurize

from torch_port_helpers import tiny_config_dict


@pytest.mark.parametrize("lengths", [(48, 30, 17), (64, 64, 5)])
def test_featurize_batch_matches_jax(lengths):
    rng = np.random.default_rng(sum(lengths))
    n = max(lengths)
    bb = np.zeros((len(lengths), n, 3, 3), np.float32)
    mask = np.zeros((len(lengths), n), bool)
    for i, L in enumerate(lengths):
        bb[i, :L] = helix_backbone(rng, L)
        mask[i, :L] = True
    want, want_pair = featurize_batch_jax(jnp.asarray(bb), jnp.asarray(mask),
                                          5)
    got, pair = featurize_batch(torch.from_numpy(bb), torch.from_numpy(mask))
    assert got.shape == (len(lengths), n, n, 5) and got.dtype == torch.float32
    assert not torch.isnan(got).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(pair.numpy(), np.asarray(want_pair))


def test_featurize_batch_refuses_the_c8_layout():
    """C=8 without the SS block channels is refused (with them it is held
    to JAX in test_torch_ss.py)."""
    bb = torch.zeros((1, 8, 3, 3))
    with pytest.raises(ValueError, match="C=8"):
        featurize_batch(bb, torch.ones((1, 8), dtype=torch.bool), 8)


def test_trainer_batch_featurized_on_device_matches_the_host(tmp_path):
    """One batch of records: shipped as backbones (bb, mask_res, ss_spans,
    length, as the JAX package ships them) and featurized in the step,
    against the host-featurized maps of the records (atol 1e-5)."""
    write_records(tmp_path, 4, lengths=(9, 16), seed=5)
    recs = [ProteinProcessedDataset(tmp_path)[i] for i in range(4)]
    batch = make_batch(recs, 16)
    host_cfg = load_config(tiny_config_dict())
    dev_cfg = load_config(tiny_config_dict())
    dev_cfg.data.featurize_on_device = True
    host = batch_to_device_arrays(batch, host_cfg)
    shipped = batch_to_device_arrays(batch, dev_cfg)
    assert set(shipped) == {"bb", "mask_res", "ss_spans", "length"}
    assert shipped["bb"].shape == (4, 16, 3, 3)
    got = featurize(dev_cfg, shipped)
    assert featurize(host_cfg, host) is host
    np.testing.assert_array_equal(got["mask_pair"].numpy(),
                                  host["mask_pair"].numpy())
    np.testing.assert_allclose(got["coords_6d"].numpy(),
                               host["coords_6d"].numpy(), atol=1e-5, rtol=0)
    torch.testing.assert_close(got["length"], host["length"])


def test_train_cli_with_the_n256_settings_at_tiny_width(tmp_path):
    """cli/train.main for 2 steps on the CPU with quality_n256.yml's
    settings at the tiny widths: bf16, remat of the residual blocks,
    featurization on the device, dropout 0.1. Finite losses and EMA weights
    apart from the trained ones."""
    write_records(tmp_path, 6, lengths=(9, 16))
    cfg = tiny_config_dict(dropout=0.1, dtype="bfloat16",
                           norm_dtype="bfloat16", remat_resblocks=True)
    cfg["training"].update({"batch_size": 2, "log_freq": 1})
    cfg["data"]["featurize_on_device"] = True
    cfg["optim"] = {"warmup": 2}
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))
    res = ttrain.main(["--config", str(tmp_path / "cfg.yml"), "--data",
                       str(tmp_path), "--max_steps", "2", "--device",
                       "cpu", "--workdir_root", str(tmp_path / "runs")])
    assert res["steps"] == 2 and np.isfinite(res["losses"]).all()
    assert np.isfinite(res["eval_loss"])
    state = res["state"]
    assert state.model.dtype == torch.bfloat16
    params = dict(state.model.named_parameters())
    assert any(not torch.equal(params[k], state.ema.params[k])
               for k in params)
