"""The port's mesh rules in one process (parallel/mesh.py): the axis sizes
against the JAX trainer's rule, each rank's rows against the JAX package's
`P("data")` shards on the 8 virtual CPU devices, the row-keeping generator
(with remat), the per-node loader against the JAX loader, the `mesh`
config section, the fused multi-step against single steps, and a mesh
that does not fit the world.
"""

import math

import numpy as np
import pytest
import torch
import yaml

from text2protein_tpu_torch.cli import train as ttrain
from text2protein_tpu_torch.config import CONFIGS, load_config
from text2protein_tpu_torch.data.helix_records import write_records
from text2protein_tpu_torch.diffusion.sde import get_sde
from text2protein_tpu_torch.models import layers
from text2protein_tpu_torch.parallel.mesh import (
    Mesh,
    RowGenerator,
    batch_rows,
    mesh_axes,
    rand,
    randn,
    row_generator,
    shard_batch,
)
from text2protein_tpu_torch.training.steps import (
    make_multi_train_step,
    make_train_step,
)

import torch_dist_workers as W
from torch_port_helpers import (  # noqa: F401  (a fixture)
    C,
    CONTEXT_DIM,
    N,
    one_torch_thread,
    tiny_config_dict,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _jax_trainer_axes(batch_size, n_dev, data, model):
    """text2protein_tpu/cli/train.py:187-200, line for line."""
    model_axis = max(int(model), 1)
    data_req = int(data) if int(data) != -1 else n_dev // model_axis
    return math.gcd(batch_size, data_req), model_axis


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_mesh_axes_follow_the_jax_trainer(world):
    """Where the JAX rule's data x model fills the world, the port takes the
    same axes (and JAX's make_mesh builds them on the virtual devices);
    elsewhere the port raises and names the sizes."""
    import jax

    from text2protein_tpu.parallel.mesh import make_mesh as j_make_mesh

    for bs in (1, 2, 3, 4, 6, 8, 16):
        for data in (-1, 1, 2, 4):
            for model in (1, 2, 4):
                want = _jax_trainer_axes(bs, world, data, model)
                if want[0] * want[1] == world:
                    assert mesh_axes(bs, world, data, model) == want
                    jm = j_make_mesh(*want, devices=jax.devices()[:world])
                    assert dict(jm.shape) == {"data": want[0],
                                              "model": want[1]}
                else:
                    with pytest.raises(ValueError, match=(
                            f"data={want[0]} x model={want[1]}.*world size "
                            f"{world}")):
                        mesh_axes(bs, world, data, model)


@pytest.mark.parametrize("data,model", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_batch_rows_are_the_jax_data_shards(data, model):
    """Each rank's rows of a 16-row batch: the rows JAX's batch sharding
    puts on the device at the same place of make_mesh(data, model)."""
    import jax

    from text2protein_tpu.parallel.mesh import (
        batch_sharding,
        make_mesh,
        put_array,
    )

    jm = make_mesh(data, model, devices=jax.devices()[:8])
    x = put_array(np.arange(16 * 3).reshape(16, 3), batch_sharding(jm))
    where = {dev: tuple(int(i) for i in np.argwhere(jm.devices == dev)[0])
             for dev in jm.devices.flat}
    for shard in x.addressable_shards:
        d, m = where[shard.device]
        mesh = Mesh(data, model, rank=d * model + m)
        assert (mesh.data_index, mesh.model_index) == (d, m)
        lo, hi = batch_rows(mesh, 16)
        np.testing.assert_array_equal(np.asarray(shard.data),
                                      np.arange(48).reshape(16, 3)[lo:hi])


@pytest.mark.parametrize("host_count", [1, 2])
def test_shard_batch_takes_the_rows_of_the_node(host_count):
    """Each node holds its batch_size rows of the global batch: a rank's
    rows of its node's batch are its rows of the global batch; a batch that
    every node holds whole (per_node=False) is cut by the global rule."""
    bs, data, model = 4, 4, 2
    glob = {"x": np.arange(bs * host_count * 2).reshape(-1, 2),
            "caption": [f"c{i}" for i in range(bs * host_count)],
            "name": "kept"}
    for rank in range(data * model):
        mesh = Mesh(data, model, rank=rank, host_count=host_count)
        lo, hi = batch_rows(mesh, bs * host_count)
        node = {k: (v[mesh.host_id * bs:(mesh.host_id + 1) * bs]
                    if k != "name" else v) for k, v in glob.items()}
        rows = shard_batch(mesh, node)
        np.testing.assert_array_equal(rows["x"], glob["x"][lo:hi])
        assert rows["caption"] == glob["caption"][lo:hi]
        assert rows["name"] == "kept"
        whole = shard_batch(mesh, node, per_node=False)
        lo, hi = batch_rows(mesh, bs)
        np.testing.assert_array_equal(whole["x"], node["x"][lo:hi])


def test_row_generator_keeps_the_rows_of_global_draws():
    """A draw of a rank's rows is those rows of the draw for the global
    batch; a 0-d draw is the global one; the generators advance alike."""
    for data_index in range(4):
        mesh = Mesh(4, 1, rank=data_index)
        g = row_generator(torch.Generator().manual_seed(1), mesh, 2)
        ref = torch.Generator().manual_seed(1)
        assert isinstance(g, RowGenerator)
        lo = 2 * data_index
        assert torch.equal(rand((2, 3), g),
                           torch.rand((8, 3), generator=ref)[lo:lo + 2])
        assert torch.equal(rand((), g), torch.rand((), generator=ref))
        assert torch.equal(randn((2, 5, 5), g),
                           torch.randn((8, 5, 5), generator=ref)[lo:lo + 2])
        assert torch.equal(g.get_state(), ref.get_state())
        with pytest.raises(ValueError):
            rand((3,), g)
    plain = torch.Generator()
    assert row_generator(plain, None, 2) is plain
    assert row_generator(plain, Mesh(1, 4, rank=3), 2) is plain


def test_remat_replays_a_row_generator():
    """Dropout under `layers.remat` from a RowGenerator: the recompute
    draws the same rows, so the gradient is the plain call's, and the
    generator stands where the forward left it."""
    drop = layers.Dropout(0.5).train()

    def block(x, generator=None):
        return drop(x.sin(), generator)

    mesh = Mesh(2, 1, rank=1)
    x = torch.randn(3, 16, requires_grad=True)

    def gen():
        return row_generator(torch.Generator().manual_seed(3), mesh, 3)

    g = gen()
    block(x, generator=g).sum().backward()
    want, after = x.grad.clone(), g.get_state()
    x.grad = None
    g = gen()
    y = layers.remat(block, x, generator=g)
    y.sum().backward()
    assert torch.equal(x.grad, want)
    assert torch.equal(g.get_state(), after)


def test_per_node_loader_matches_the_jax_loader(tmp_path):
    """PrefetchLoader with host_id / host_count: each node's batches hold
    the records of the JAX loader's batches, index for index."""
    from text2protein_tpu.data.dataset import ProteinProcessedDataset as JD
    from text2protein_tpu.data.loader import PrefetchLoader as JLoader
    from text2protein_tpu_torch.data.dataset import ProteinProcessedDataset
    from text2protein_tpu_torch.data.loader import PrefetchLoader

    write_records(tmp_path, 11, lengths=(9, 16))
    indices = np.random.RandomState(0).permutation(11)
    for host_count in (1, 2, 3):
        for host_id in range(host_count):
            got = [b["index"] for b in PrefetchLoader(
                ProteinProcessedDataset(tmp_path), indices, 2, N, seed=7,
                host_id=host_id, host_count=host_count)]
            want = [b["index"] for b in JLoader(
                JD(tmp_path), indices, 2, N, seed=7, host_id=host_id,
                host_count=host_count)]
            assert len(got) == len(want) == len(indices[host_id::
                                                        host_count]) // 2
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_node_stream_resumes_inside_its_epoch(tmp_path):
    """A node's training stream from step s is its stream from step 0
    without the first s batches, across its (shorter) epochs."""
    from text2protein_tpu_torch.data.dataset import ProteinProcessedDataset

    write_records(tmp_path, 11, lengths=(9, 16))
    ds = ProteinProcessedDataset(tmp_path)
    idx = np.arange(11)

    def take(step, k, host_id):
        s = ttrain.train_batches_from(ds, idx, 2, N, 5, step, host_id, 2)
        return [next(s)["index"] for _ in range(k)]

    for host_id in (0, 1):
        full = take(0, 7, host_id)
        for step in (1, 2, 3, 5):
            for a, b in zip(take(step, 7 - step, host_id), full[step:]):
                np.testing.assert_array_equal(a, b)


def test_mesh_section_is_the_jax_default_in_every_config():
    """load_config({}) and every configs/*.yml give the JAX package's
    `mesh` section."""
    from text2protein_tpu.config import load_config as j_load_config

    assert load_config({}).mesh.to_dict() == {"data": -1, "model": 1}
    assert load_config({}).mesh.to_dict() == dict(j_load_config({}).mesh)
    for path in sorted(CONFIGS.glob("*.yml")):
        got = load_config(path).mesh.to_dict()
        assert got == dict(j_load_config(str(path)).mesh), path.name


def test_trainer_refuses_a_mesh_that_does_not_fit(tmp_path):
    """mesh.model 2 in one process: the trainer raises before it reads a
    record, naming the sizes, instead of training on one device."""
    cfg = tiny_config_dict()
    cfg["mesh"] = {"data": -1, "model": 2}
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))
    with pytest.raises(ValueError, match="model=2.*world size 1"):
        ttrain.main(["--config", str(tmp_path / "cfg.yml"), "--data",
                     str(tmp_path / "none"), "--device", "cpu",
                     "--workdir_root", str(tmp_path / "runs")])
    assert not (tmp_path / "runs").exists()


def test_multi_train_step_equals_k_single_steps():
    """make_multi_train_step over 3 batches: the losses and the state of 3
    calls of train_step, bit for bit (dropout 0.1, random inpainting
    masks)."""
    cfg_dict = tiny_config_dict(dropout=0.1,
                                condition=["length", "inpainting"])
    rng = np.random.default_rng(0)

    def batch():
        lengths = rng.integers(9, N + 1, 2).astype(np.int32)
        row = np.arange(N)[None, :] < lengths[:, None]
        mp = row[:, :, None] & row[:, None, :]
        return W.tensors({
            "coords_6d": rng.uniform(-1, 1, (2, N, N, C)).astype(np.float32),
            "mask_pair": mp, "ss_spans": np.full((2, 32, 2), -1, np.int32),
            "length": lengths,
            "context": rng.standard_normal((2, 8, CONTEXT_DIM))
            .astype(np.float32),
            "context_mask": np.ones((2, 8), bool)})

    batches = [batch() for _ in range(3)]
    cfg, a = W.build_state(cfg_dict)
    _, b = W.build_state(cfg_dict)
    sde, _ = get_sde(cfg)
    step = make_train_step(cfg, sde, a.model)
    want = [step(a, x, 9) for x in batches]
    got = make_multi_train_step(cfg, sde, b.model)(b, batches, 9)
    assert torch.equal(got, torch.stack(want))
    assert a.step == b.step == 3
    for k, p in a.model.named_parameters():
        assert torch.equal(p, dict(b.model.named_parameters())[k]), k
        assert torch.equal(a.ema.params[k], b.ema.params[k]), k
