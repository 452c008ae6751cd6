"""The port's text path against the JAX package, on the CPU.

The hashed-token, cached and Hugging Face encoders, the caption cache
(`encode_captions`, `cli/text_preprocess`), `build_text_encoder` with its
hash fallback, and `text/llama.embed_with_query`: the same captions, ids
and local checkpoint files go through both packages, and the outputs must
be equal (atol 0). The HF checkpoints are a tiny Llama and a word-level
tokenizer written into tmp_path in the three layouts `_load_embed_table`
reads (as tests/test_text_checkpoint.py builds them): nothing is fetched.
"""

import json

import numpy as np
import pytest
import torch
import yaml
from tokenizers import Tokenizer, models, pre_tokenizers
from transformers import (
    LlamaConfig,
    LlamaForCausalLM,
    PreTrainedTokenizerFast,
)

from text2protein_tpu.cli import text_preprocess as j_text_preprocess
from text2protein_tpu.config import load_config as j_load_config
from text2protein_tpu.text import encoder as jenc
from text2protein_tpu.text import llama as j_llama
from text2protein_tpu_torch.cli import text_preprocess
from text2protein_tpu_torch.config import load_config
from text2protein_tpu_torch.text import encoder as tenc
from text2protein_tpu_torch.text import llama as t_llama

from torch_port_helpers import tiny_config_dict

CAPTIONS = {
    "1abc": "synthetic alpha helical bundle protein with 3 helices",
    "2xyz": "protein with 128 residues",
    "3def": "alpha helical bundle with 2 helices and 64 residues and a "
            "long tail of words that runs past the bucket",
    "4ghi": "",
}
WORDS = ["<unk>", "<pad>", "synthetic", "alpha", "helical", "bundle",
         "protein", "with", "helices", "and", "residues"] + [
    str(n) for n in range(10)]


def _configs(**text):
    cfg = tiny_config_dict()
    cfg["text"] = dict(cfg["text"], **text)
    return load_config(cfg), j_load_config(cfg)


@pytest.fixture(scope="module")
def tiny_llama(tmp_path_factory):
    """(directory, model): a tiny Llama saved as a single safetensors file
    with a word-level tokenizer beside it."""
    d = tmp_path_factory.mktemp("tiny_llama")
    cfg = LlamaConfig(vocab_size=128, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=2,
                      num_key_value_heads=2)
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg)
    model.save_pretrained(d, safe_serialization=True)
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(WORDS)},
                                     unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                            pad_token="<pad>").save_pretrained(d)
    return d, model


def _layout(tiny_llama, tmp_path, layout):
    """The checkpoint directory of one layout, the tokenizer files copied
    in."""
    d, model = tiny_llama
    if layout == "single":
        return d
    out = tmp_path / layout
    if layout == "sharded":
        model.save_pretrained(out, safe_serialization=True,
                              max_shard_size="20KB")
        assert (out / "model.safetensors.index.json").exists()
    else:
        model.save_pretrained(out, safe_serialization=False)
        assert (out / "pytorch_model.bin").exists()
    for f in d.iterdir():
        if "token" in f.name:
            (out / f.name).write_bytes(f.read_bytes())
    return out


def test_hash_encoder_matches_jax():
    cfg, jcfg = _configs(pad_to_bucket=8, max_tokens=16)
    got = tenc.build_text_encoder(cfg)
    want = jenc.build_text_encoder(jcfg)
    assert isinstance(got, tenc.HashTextEncoder)
    for caps in (list(CAPTIONS.values()), ["one"], ["a b c"] * 3):
        for g, w in zip(got.encode(caps), want.encode(caps)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_encode_captions_writes_the_jax_npz(tmp_path):
    cfg, jcfg = _configs(pad_to_bucket=8, max_tokens=16)
    got = tenc.encode_captions(CAPTIONS, tenc.build_text_encoder(cfg),
                               tmp_path / "port.npz")
    want = jenc.encode_captions(CAPTIONS, jenc.build_text_encoder(jcfg),
                                tmp_path / "jax.npz")
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        assert "1abc__len" in g.files
        for k in w.files:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("ids", [["1abc", "2xyz"], ["3def"], ["4ghi", "1abc",
                                                              "3def"]])
def test_cached_encoder_matches_jax(tmp_path, ids):
    """encode_ids on the npz JAX's encode_captions wrote, through
    `text.encoder: cache`."""
    _, jcfg = _configs(pad_to_bucket=8, max_tokens=16)
    path = jenc.encode_captions(CAPTIONS, jenc.build_text_encoder(jcfg),
                                tmp_path / "cache.npz")
    cfg, jcfg = _configs(encoder="cache", cache_path=str(path),
                         pad_to_bucket=8, max_tokens=16)
    got = tenc.build_text_encoder(cfg)
    want = jenc.build_text_encoder(jcfg)
    assert isinstance(got, tenc.CachedTextEncoder) and got.dim == want.dim
    for g, w in zip(got.encode_ids(ids), want.encode_ids(ids)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(TypeError):
        got.encode(["a caption"])


@pytest.mark.parametrize("layout", ["single", "sharded", "bin"])
def test_hf_encoder_matches_jax(tiny_llama, tmp_path, layout):
    """`text.encoder: hf` on local files: the embeddings and the mask equal
    the JAX package's, atol 0, in each checkpoint layout; `padded_width`
    gives the width `encode` pads to."""
    d = _layout(tiny_llama, tmp_path, layout)
    cfg, jcfg = _configs(encoder="hf", model_name=str(d), max_tokens=16,
                         pad_to_bucket=8)
    got = tenc.build_text_encoder(cfg)
    want = jenc.build_text_encoder(jcfg)
    assert isinstance(got, tenc.HFEmbeddingEncoder) and got.dim == 32
    caps = list(CAPTIONS.values())
    for batch in (caps, caps[:1], caps[1:2]):
        g_emb, g_mask = got.encode(batch)
        w_emb, w_mask = want.encode(batch)
        assert g_emb.dtype == np.float32 and g_emb.shape[1] % 8 == 0
        assert got.padded_width(batch) == g_emb.shape[1]
        np.testing.assert_array_equal(g_emb, w_emb)
        np.testing.assert_array_equal(g_mask, w_mask)
    # the table is the checkpoint's embedding rows, read alone
    np.testing.assert_array_equal(
        tenc._load_embed_table(str(d)).numpy(),
        tiny_llama[1].get_input_embeddings().weight.detach().numpy())


def test_hf_without_weights_falls_back_to_hash(tmp_path, capsys):
    missing = str(tmp_path / "no_such_model")
    cfg, jcfg = _configs(encoder="hf", model_name=missing, max_tokens=16,
                         pad_to_bucket=8)
    want = jenc.build_text_encoder(jcfg)
    want_out = capsys.readouterr().out
    got = tenc.build_text_encoder(cfg)
    got_out = capsys.readouterr().out
    assert isinstance(got, tenc.HashTextEncoder)
    assert got_out == want_out
    assert got_out.startswith("[text] HF encoder unavailable (")
    assert got_out.endswith("); falling back to hash\n")
    for g, w in zip(got.encode(["a helix"]), want.encode(["a helix"])):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("as_list", [False, True])
def test_text_preprocess_cli_matches_jax(tmp_path, as_list):
    """`cli/text_preprocess CONFIG --out X --limit 3` on a captions json (an
    object, or the list of {pdb_id, caption}): the same npz as JAX's."""
    ann = ([{"pdb_id": k, "caption": v} for k, v in CAPTIONS.items()]
           if as_list else CAPTIONS)
    (tmp_path / "captions.json").write_text(json.dumps(ann))
    cfg = tiny_config_dict()
    cfg["data"]["caption_path"] = str(tmp_path / "captions.json")
    cfg["text"].update(max_tokens=16, pad_to_bucket=8)
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))
    got = text_preprocess.main([str(tmp_path / "cfg.yml"), "--out",
                                str(tmp_path / "port.npz"), "--limit", "3"])
    j_text_preprocess.main([str(tmp_path / "cfg.yml"), "--out",
                            str(tmp_path / "jax.npz"), "--limit", "3"])
    with np.load(got) as g, np.load(tmp_path / "jax.npz") as w:
        assert sorted(g.files) == sorted(w.files)
        assert len(g.files) == 6  # 3 ids, each with its length
        for k in w.files:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("with_query", [False, True])
def test_embed_with_query_matches_jax(tiny_llama, with_query):
    _, model = tiny_llama
    ids = torch.tensor([[2, 3, 4, 5], [6, 7, 8, 0]])
    mask = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0]])
    query = (torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 32)).astype(np.float32)) if with_query else None)
    with torch.no_grad():
        got = t_llama.embed_with_query(model, ids, query, mask)
        want = j_llama.embed_with_query(model, ids, query, mask)
        out = t_llama.forward_with_query(model, ids, query,
                                         attention_mask=mask).logits
        j_out = j_llama.forward_with_query(model, ids, query,
                                           attention_mask=mask).logits
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        assert torch.equal(g, w)
    assert got[0].shape[1] == 4 + (3 if with_query else 0)
    assert torch.equal(out, j_out)


def test_port_imports_no_hf_or_tensorboard_at_import_time():
    """`transformers`, `tokenizers`, `safetensors` and `tensorboardX` are
    imported only inside the functions that need them (the GPU machine
    has none): a clean process importing every module of the port and
    chip_smoke.py loads none of them."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    mods = sorted(".".join(p.relative_to(repo).with_suffix("").parts)
                  for p in (repo / "text2protein_tpu_torch").rglob("*.py"))
    code = "\n".join(f"import {m}" for m in mods + ["chip_smoke"])
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=repo, capture_output=True, text=True, timeout=300, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if m.split(".")[0] in (
        "transformers", "tokenizers", "safetensors", "tensorboardX")]
    assert not bad, bad
