"""The port's trainer against the JAX trainer's data order and its resident
context table, on the CPU.

1. The data order: `train_batches_from(..., step=0)` gives the JAX
   trainer's stream, whose first draw of RandomState(seed) shuffles the
   batch the JAX trainer initializes its state from
   (text2protein_tpu/cli/train.py:205,348,451-454); both packages'
   PrefetchLoaders read the same records.
2. The context of each train step (text2protein_tpu/cli/train.py:250-346,
   469-481): with `data.featurize_on_device` and `steps_per_launch` K > 1,
   the steps of full groups of K take the rows of the deduplicated bf16
   table, cast to f32, equal bit for bit to the table the JAX trainer
   builds from the same dataset; the tail steps and the eval pass take the
   f32 encode; over `data.max_context_table_bytes` every step does.
3. `batch["index"]` and `caption(idx)` against the JAX loader and dataset.
"""

import itertools
import json

import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

from text2protein_tpu.cli.train import batches as j_batches
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.data.dataset import ProteinProcessedDataset as JDataset
from text2protein_tpu.data.loader import PrefetchLoader as JLoader
from text2protein_tpu.text import build_text_encoder as j_build_text_encoder
from text2protein_tpu_torch.cli import train as ttrain
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.data.dataset import ProteinProcessedDataset
from text2protein_tpu_torch.data.helix_records import (
    abstract_captions,
    write_records,
)
from text2protein_tpu_torch.data.loader import PrefetchLoader
from text2protein_tpu_torch.text.encoder import build_text_encoder

from torch_port_helpers import (  # noqa: F401  (a fixture)
    N,
    one_torch_thread,
    tiny_config_dict,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K, BUDGET, BS = 3, 7, 2  # 2 full groups of 3 steps and 1 tail step


def _jax_table(config_dict, root):
    """The JAX trainer's resident table, built as its
    build_context_table_host does (text2protein_tpu/cli/train.py:269-283)
    from the JAX dataset and encoder: (table bf16, mask table, inv)."""
    ds = JDataset(root)
    enc = j_build_text_encoder(j_load_config(config_dict))
    uniq = {}
    inv = np.empty(len(ds), np.int32)
    for i in range(len(ds)):
        inv[i] = uniq.setdefault(ds.caption(i), len(uniq))
    ucaps = list(uniq)
    embs, masks = [], []
    for i in range(0, len(ucaps), 64):
        e, m = enc.encode(ucaps[i:i + 64])
        embs.append(np.asarray(e))
        masks.append(np.asarray(m))
    t_max = max(e.shape[1] for e in embs)
    embs = [np.pad(e, ((0, 0), (0, t_max - e.shape[1]), (0, 0)))
            for e in embs]
    masks = [np.pad(m, ((0, 0), (0, t_max - m.shape[1]))) for m in masks]
    return (np.concatenate(embs).astype(ml_dtypes.bfloat16),
            np.concatenate(masks).astype(bool), inv)


# ------------------------------------------------------------ data order


def test_train_stream_is_the_jax_trainers_first_two_epochs(tmp_path):
    """Seed 42 over 100 indices: the first two epochs' batches, index for
    index, are the JAX trainer's after its init-batch draw."""
    write_records(tmp_path, 100, lengths=(9, 16))
    idx, bs = np.arange(100), 4
    per_epoch = len(idx) // bs
    host_rng = np.random.RandomState(42)
    jds = JDataset(tmp_path)
    for _ in j_batches(jds, idx, bs, N, host_rng):  # the init batch's epoch
        pass
    want = [b["index"] for epoch in range(2)
            for b in j_batches(jds, idx, bs, N, host_rng)]
    stream = ttrain.train_batches_from(ProteinProcessedDataset(tmp_path),
                                       idx, bs, N, 42, 0)
    got = [b["index"] for b in itertools.islice(stream, 2 * per_epoch)]
    assert len(want) == len(got) == 2 * per_epoch
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the stream the port drew before the repair (epoch e with draw e + 1)
    # starts elsewhere
    old = np.random.RandomState(np.random.RandomState(42).randint(2**31))
    assert not np.array_equal(old.permutation(idx)[:bs], got[0])


# -------------------------------------------------------- context table


def _cfg(tmp_path, **data):
    cfg = tiny_config_dict()
    cfg["training"].update(batch_size=BS, steps_per_launch=K, log_freq=2,
                           eval_freq=100, snapshot_freq_for_preemption=100)
    cfg["data"].update(featurize_on_device=True, **data)
    cfg["optim"] = {"warmup": 2}
    path = tmp_path / "cfg.yml"
    path.write_text(yaml.safe_dump(cfg))
    return cfg, path


class _Recorder:
    """Wraps the trainer's batch stream, eval loader and steps to record
    each step's host batch and the context the step received."""

    def __init__(self, monkeypatch):
        self.train_batches, self.train_ctx = [], []
        self.eval_batches, self.eval_ctx = [], []
        real_stream = ttrain.train_batches_from
        real_batches = ttrain.batches
        real_train = ttrain.make_train_step
        real_eval = ttrain.make_eval_step

        def stream(*a, **k):
            for b in real_stream(*a, **k):
                self.train_batches.append(b)
                yield b

        def batches(*a, **k):
            for b in real_batches(*a, **k):
                self.eval_batches.append(b)
                yield b

        def wrap(make, out):
            def make_step(*a, **k):
                step = make(*a, **k)

                def run(state, batch, seed):
                    out.append((batch["context"].clone(),
                                batch["context_mask"].clone()))
                    return step(state, batch, seed)
                return run
            return make_step

        monkeypatch.setattr(ttrain, "train_batches_from", stream)
        monkeypatch.setattr(ttrain, "batches", batches)
        monkeypatch.setattr(ttrain, "make_train_step",
                            wrap(real_train, self.train_ctx))
        monkeypatch.setattr(ttrain, "make_eval_step",
                            wrap(real_eval, self.eval_ctx))


def _train(tmp_path, cfg_path, steps):
    return ttrain.main(["--config", str(cfg_path), "--data",
                        str(tmp_path / "rec"), "--max_steps", str(steps),
                        "--device", "cpu", "--workdir_root",
                        str(tmp_path / "runs")])


def _assert_encoded(encoder, batches, contexts):
    for b, (ctx, mask) in zip(batches, contexts, strict=True):
        emb, emb_mask = encoder.encode(b["caption"])
        assert ctx.dtype == torch.float32
        np.testing.assert_array_equal(ctx.numpy(), emb)
        np.testing.assert_array_equal(mask.numpy(), emb_mask)


def test_each_step_takes_its_context_where_the_jax_trainer_does(
        tmp_path, monkeypatch, capsys):
    write_records(tmp_path / "rec", 24, lengths=(9, N))
    cfg, cfg_path = _cfg(tmp_path)
    rec = _Recorder(monkeypatch)
    res = _train(tmp_path, cfg_path, BUDGET)
    assert res["steps"] == BUDGET and np.isfinite(res["losses"]).all()
    table, mask_table, inv = _jax_table(cfg, tmp_path / "rec")
    assert res["table_steps"] == 2 * K
    assert res["context_table"] == {"unique": 5, "bytes": table.nbytes}
    assert (f"resident context table: 5 unique captions, "
            f"{table.nbytes / 2**20:.1f} MiB") in capsys.readouterr().out
    encoder = build_text_encoder(load_config(cfg))
    assert len(rec.train_ctx) == BUDGET
    for b, (ctx, mask) in zip(rec.train_batches[:2 * K],
                              rec.train_ctx[:2 * K]):
        rows = inv[b["index"]]
        want = table[rows].astype(np.float32)
        assert ctx.dtype == torch.float32
        np.testing.assert_array_equal(ctx.numpy().view(np.uint32),
                                      want.view(np.uint32))
        np.testing.assert_array_equal(mask.numpy(), mask_table[rows])
    # a table row differs from its f32 encode (the bf16 round), so the
    # check above tells the two sources apart
    emb, _ = encoder.encode(rec.train_batches[0]["caption"])
    width = min(emb.shape[1], rec.train_ctx[0][0].shape[1])
    assert not np.array_equal(rec.train_ctx[0][0].numpy()[:, :width],
                              emb[:, :width])
    _assert_encoded(encoder, rec.train_batches[2 * K:BUDGET],
                    rec.train_ctx[2 * K:])
    assert rec.eval_ctx
    _assert_encoded(encoder, rec.eval_batches, rec.eval_ctx)


def test_table_rows_are_the_bf16_round_of_each_records_encode(tmp_path):
    """table[inv[i]] == bf16(encode(caption(i))), masks bit-equal, and the
    port's table is the JAX trainer's bit for bit
    (tests/test_train_resident.py checks the first for JAX)."""
    write_records(tmp_path / "rec", 12, lengths=(9, N))
    cfg, _ = _cfg(tmp_path)
    ds = ProteinProcessedDataset(tmp_path / "rec")
    encoder = build_text_encoder(load_config(cfg))
    table, mask_table, inv = ttrain.build_context_table(ds, encoder)
    j_table, j_mask, j_inv = _jax_table(cfg, tmp_path / "rec")
    assert table.dtype == torch.bfloat16
    np.testing.assert_array_equal(inv.numpy(), j_inv)
    np.testing.assert_array_equal(table.view(torch.int16).numpy(),
                                  j_table.view(np.int16))
    np.testing.assert_array_equal(mask_table.numpy(), j_mask)
    for i in range(len(ds)):
        e, m = encoder.encode([ds.caption(i)])
        t = e.shape[1]
        row = table[inv[i]].float().numpy()
        want = torch.from_numpy(e[0]).to(torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(row[:t], want)
        assert not row[t:].any()
        np.testing.assert_array_equal(mask_table[inv[i]].numpy()[:t], m[0])
        assert not mask_table[inv[i]].numpy()[t:].any()


def test_over_the_cap_prints_the_jax_line_and_ships_f32(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    write_records(tmp_path / "rec", 24, lengths=(9, N))
    cfg, cfg_path = _cfg(tmp_path, max_context_table_bytes=1)
    rec = _Recorder(monkeypatch)
    res = _train(tmp_path, cfg_path, K)
    table, _, _ = _jax_table(cfg, tmp_path / "rec")
    out = capsys.readouterr().out
    assert (f"context table is {table.nbytes / 2**30:.1f} GiB for 5 unique "
            f"captions (> {1 / 2**30:.1f} cap); using per-launch context "
            f"shipping") in out
    assert "resident context table" not in out
    assert res["table_steps"] == 0 and res["context_table"] is None
    _assert_encoded(build_text_encoder(load_config(cfg)), rec.train_batches,
                    rec.train_ctx)


@pytest.mark.parametrize("over", [True, False], ids=["over", "at_cap"])
def test_the_cap_is_checked_before_any_caption_is_encoded(tmp_path,
                                                          monkeypatch,
                                                          capsys, over):
    """A deliberate difference from the JAX trainer, which encodes every
    unique caption into the table and then compares its bytes with
    `data.max_context_table_bytes` (text2protein_tpu/cli/train.py:286-299).
    The port computes the same bytes from the captions' tokens alone
    (`context_table_size`: unique x bucket x context_dim x 2) and, over
    the cap, encodes nothing; the printed line and the choice are the JAX
    trainer's. Abstract-length captions, so that the records span several
    buckets; at a cap of exactly the table's bytes the table is built."""
    captions = abstract_captions(7, seed=3, tokens=(40, 300))
    write_records(tmp_path / "rec", 24, lengths=(9, N), captions=captions)
    cfg, _ = _cfg(tmp_path)
    j_table, _, _ = _jax_table(cfg, tmp_path / "rec")
    assert j_table.shape[1] > 64  # the longest caption's bucket
    cap = j_table.nbytes - 1 if over else j_table.nbytes
    cfg["data"]["max_context_table_bytes"] = cap
    config = load_config(cfg)
    ds = ProteinProcessedDataset(tmp_path / "rec")
    encoder = build_text_encoder(config)
    assert ttrain.context_table_size(ds, encoder) == (7, j_table.nbytes)
    encoded = []
    real_encode = encoder.encode
    monkeypatch.setattr(encoder, "encode", lambda c: encoded.append(
        len(c)) or real_encode(c))
    res = ttrain.resident_table(config, ds, encoder, torch.device("cpu"))
    out = capsys.readouterr().out
    if over:
        assert res is None and encoded == []
        assert out == (f"context table is {j_table.nbytes / 2**30:.1f} GiB "
                       f"for 7 unique captions (> {cap / 2**30:.1f} cap); "
                       f"using per-launch context shipping\n")
    else:
        assert encoded == [7] and res["bytes"] == j_table.nbytes
        assert out == (f"resident context table: 7 unique captions, "
                       f"{j_table.nbytes / 2**20:.1f} MiB\n")


@pytest.mark.parametrize("start,budget,k,want", [
    (0, 7, 3, 6), (0, 6, 3, 6), (0, 2, 3, 0), (2, 7, 3, 5), (4, 23, 10, 14),
    (0, 23, 10, 20)])
def test_table_steps_end_counts_full_groups_from_the_start(start, budget, k,
                                                          want):
    """The JAX trainer's launches (text2protein_tpu/cli/train.py:469-481):
    k = min(K, budget - step) each, fused only when k == K."""
    step, fused_end = start, start
    while step < budget:
        n = min(k, max(1, budget - step))
        if n == k:
            fused_end = step + n
        step += n
    assert ttrain.table_steps_end(start, budget, k) == fused_end == want


def _jax_eval_steps(start, budget, k, eval_freq):
    """The steps at which the JAX trainer evaluates: after each pass of its
    loop (a fused launch of K steps, or the tail's steps one by one) once
    eval_freq steps have passed, and at the end
    (text2protein_tpu/cli/train.py:466-525)."""
    step = last = start
    out = []
    while step < budget:
        step += min(k, max(1, budget - step))
        if step - last >= eval_freq or step >= budget:
            last = step
            out.append(step)
    return out


def test_eval_boundaries_fall_at_steps_not_at_launch_ends(tmp_path):
    """A deliberate difference: the port runs every step as its own call,
    so with eval_freq 2 and K 3 it evaluates at steps 2, 4, 6 and 7, where
    the JAX trainer, whose fused launches end at 3 and 6, evaluates at 3, 6
    and 7. Where eval_freq, log_freq and the checkpoint cadence are
    multiples of K (every yml of the repo with K > 1), the two agree."""
    write_records(tmp_path / "rec", 24, lengths=(9, N))
    cfg, _ = _cfg(tmp_path)
    cfg["training"]["eval_freq"] = 2
    path = tmp_path / "eval2.yml"
    path.write_text(yaml.safe_dump(cfg))
    res = _train(tmp_path, path, BUDGET)
    assert [e[0] for e in res["evals"]] == [2, 4, 6, 7]
    assert _jax_eval_steps(0, BUDGET, K, 2) == [3, 6, 7]
    assert _jax_eval_steps(0, 23, 10, 3000) == [23]


# ------------------------------------------------------ loader, dataset


@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 5)])
def test_batch_index_and_caption_match_jax(shuffle, seed):
    root = "data/processed_synth_text"
    ds, jds = ProteinProcessedDataset(root), JDataset(root)
    assert ds.data_paths == jds.data_paths
    idx = np.arange(3, 40, 3)
    got = list(PrefetchLoader(ds, idx, 4, 128, seed=seed, shuffle=shuffle))
    want = list(JLoader(jds, idx, 4, 128, seed=seed, shuffle=shuffle))
    assert len(got) == len(want) == len(idx) // 4
    for g, w in zip(got, want):
        assert g["index"].dtype == w["index"].dtype == np.int32
        np.testing.assert_array_equal(g["index"], w["index"])
        assert g["caption"] == w["caption"]
    for i in (0, 7, 200, len(ds) - 1):
        assert ds.caption(i) == jds.caption(i) == ds[i]["caption"]


# ------------------------------------------------------------ metrics


def test_metrics_writer_writes_the_jax_lines(tmp_path):
    """utils/logging.MetricsWriter against the JAX package's: the same
    JSONL records (the wall time aside), appended across writers;
    tensorboardX event files beside them where it imports."""
    from text2protein_tpu.utils.logging import MetricsWriter as JWriter
    from text2protein_tpu_torch.utils.logging import MetricsWriter

    rows = [("training_loss", 0.5, 10), ("avg_eval_loss", np.float32(0.25),
                                         np.int64(20))]
    for cls, name in ((MetricsWriter, "port"), (JWriter, "jax")):
        for chunk in (rows[:1], rows[1:]):
            w = cls(tmp_path / name)
            for tag, value, step in chunk:
                w.scalar(tag, value, step)
            w.close()

    def read(name):
        out = []
        for line in (tmp_path / name / "metrics.jsonl").read_text(
                ).splitlines():
            d = json.loads(line)
            assert isinstance(d.pop("time"), float)
            out.append(d)
        return out

    assert read("port") == read("jax") == [
        {"tag": "training_loss", "value": 0.5, "step": 10},
        {"tag": "avg_eval_loss", "value": 0.25, "step": 20}]
    assert sorted(p.name.split(".")[0] for p in (tmp_path / "port").glob(
        "events.out.tfevents.*")) == sorted(p.name.split(".")[0] for p in (
            tmp_path / "jax").glob("events.out.tfevents.*"))


def test_timer_and_profile_trace(tmp_path):
    from text2protein_tpu_torch.utils.logging import Timer, profile_trace

    timer = Timer()
    for _ in range(2):
        with timer.span("encode"):
            pass
    with pytest.raises(ValueError):
        with timer.span("fails"):
            raise ValueError
    assert sorted(timer.spans) == ["encode", "fails"]
    assert all(v >= 0.0 for v in timer.spans.values())
    with profile_trace(tmp_path / "off", enabled=False) as prof:
        assert prof is None
    assert not (tmp_path / "off").exists()
    with profile_trace(tmp_path / "trace") as prof:
        torch.ones(8).sum()
    assert prof is not None
    assert "traceEvents" in (tmp_path / "trace" / "trace.json").read_text()
