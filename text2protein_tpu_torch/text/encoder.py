"""Caption -> (B, T, D) context embeddings (counterpart of
text2protein_tpu/text/encoder.py).

Three encoders with one contract: float32 embeddings padded to a multiple of
`pad_to_bucket` tokens (at most `max_tokens`) and a boolean token mask.
  * `HashTextEncoder` (`encoder.py:44-102`): hashed word tokens mapped to
    fixed Gaussian rows; needs no weight file.
  * `CachedTextEncoder` (`encoder.py:105-139`): embeddings precomputed per
    pdb id into an npz by `encode_captions` (`cli/text_preprocess`).
  * `HFEmbeddingEncoder` (`encoder.py:208-255`): a Hugging Face tokenizer
    and only the token-embedding table of a causal LM read from local files.
`transformers`, `safetensors` and `tokenizers` are imported only inside the
HF encoder and `_load_embed_table`.
"""

from __future__ import annotations

import hashlib
import json
import re
from pathlib import Path

import numpy as np


def _bucket(t: int, bucket: int, t_max: int) -> int:
    t = max(1, min(t, t_max))
    return min(((t + bucket - 1) // bucket) * bucket, t_max)


class TextEncoder:
    """Interface: encode(captions: list[str]) -> (emb (B, T, D) f32,
    mask (B, T) bool)."""

    dim: int

    def encode(self, captions):
        raise NotImplementedError

    def padded_width(self, captions):
        """The token width T that `encode(captions)` pads to, from the
        tokens alone (nothing is embedded)."""
        raise NotImplementedError

    def __call__(self, captions):
        return self.encode(captions)


class HashTextEncoder(TextEncoder):
    """Deterministic hashed-wordpiece embedding table: word-boundary tokens,
    each hashed into a bucketed vocabulary and mapped to a fixed Gaussian
    embedding from a seeded counter RNG. Padded to a multiple of
    `pad_to_bucket` tokens, with a boolean token mask."""

    def __init__(self, dim=4096, vocab_size=65536, max_tokens=512,
                 pad_to_bucket=64, seed=0):
        self.dim = dim
        self.vocab_size = vocab_size
        self.max_tokens = max_tokens
        self.pad_to_bucket = pad_to_bucket
        self.seed = seed

    def _token_ids(self, text: str) -> np.ndarray:
        toks = re.findall(r"\w+|[^\w\s]", text.lower())[: self.max_tokens]
        if not toks:
            toks = [""]
        return np.array(
            [
                int.from_bytes(
                    hashlib.blake2b(t.encode(), digest_size=8).digest(),
                    "little",
                ) % self.vocab_size
                for t in toks
            ],
            dtype=np.int64,
        )

    def _embed_ids(self, ids: np.ndarray) -> np.ndarray:
        out = np.empty((len(ids), self.dim), dtype=np.float32)
        for i, tid in enumerate(ids):
            rng = np.random.default_rng(self.seed * 1_000_003 + int(tid))
            out[i] = rng.standard_normal(self.dim, dtype=np.float32) * (
                self.dim**-0.5)
        return out

    def padded_width(self, captions):
        return _bucket(max(len(self._token_ids(c)) for c in captions),
                       self.pad_to_bucket, self.max_tokens)

    def encode(self, captions):
        ids = [self._token_ids(c) for c in captions]
        t = _bucket(max(len(i) for i in ids), self.pad_to_bucket,
                    self.max_tokens)
        emb = np.zeros((len(captions), t, self.dim), dtype=np.float32)
        mask = np.zeros((len(captions), t), dtype=bool)
        for bi, tid in enumerate(ids):
            k = min(len(tid), t)
            emb[bi, :k] = self._embed_ids(tid[:k])
            mask[bi, :k] = True
        return emb, mask


class CachedTextEncoder(TextEncoder):
    """Precomputed caption embeddings looked up by pdb id
    (text2protein_tpu/text/encoder.py:105-139): the npz `encode_captions`
    writes, `{pid}` (T_i, D) and `{pid}__len`."""

    def __init__(self, cache_path, pad_to_bucket=64, max_tokens=512):
        self.cache_path = Path(cache_path)
        self.pad_to_bucket = pad_to_bucket
        self.max_tokens = max_tokens
        self._emb, self._len = {}, {}
        with np.load(self.cache_path, allow_pickle=False) as z:
            for k in z.files:
                if k.endswith("__len"):
                    continue
                self._emb[k] = z[k]
                self._len[k] = (int(z[f"{k}__len"]) if f"{k}__len" in z.files
                                else z[k].shape[0])
        self.dim = next(iter(self._emb.values())).shape[-1]

    def encode_ids(self, pdb_ids):
        lens = [self._len[i] for i in pdb_ids]
        t = _bucket(max(lens), self.pad_to_bucket, self.max_tokens)
        emb = np.zeros((len(pdb_ids), t, self.dim), dtype=np.float32)
        mask = np.zeros((len(pdb_ids), t), dtype=bool)
        for bi, pid in enumerate(pdb_ids):
            e = self._emb[pid][:t]
            emb[bi, :e.shape[0]] = e
            mask[bi, :min(lens[bi], t)] = True
        return emb, mask

    def encode(self, captions):
        raise TypeError(
            "CachedTextEncoder encodes by pdb id (encode_ids), not raw text")


_EMBED_KEYS = (
    "model.embed_tokens.weight",  # llama family
    "transformer.wte.weight",     # gpt2 family
    "embed_tokens.weight",
)


def _pick_embed_key(available):
    for k in _EMBED_KEYS:
        if k in available:
            return k
    for k in available:
        if k.endswith("embed_tokens.weight") or k.endswith("wte.weight"):
            return k
    raise KeyError(f"no embedding key among {sorted(available)[:8]}…")


def _load_embed_table(model_name):
    """Only the token-embedding weight of a Hugging Face checkpoint, as a
    float32 (vocab, dim) tensor (text2protein_tpu/text/encoder.py:142-205):
    from a single-file or sharded (index json) safetensors, else from a
    `pytorch_model.bin` or its index; the other weights are never read."""
    import torch
    from transformers.utils import cached_file

    def get(filename, required=False):
        try:
            return cached_file(model_name, filename)
        except Exception:  # a missing file: try the next layout
            if required:
                raise
            return None

    idx = get("model.safetensors.index.json")
    st = get("model.safetensors") if idx is None else None
    if idx is not None or st is not None:
        from safetensors import safe_open

        if idx is not None:
            with open(idx) as f:
                weight_map = json.load(f)["weight_map"]
            key = _pick_embed_key(weight_map)
            with safe_open(get(weight_map[key], required=True),
                           framework="pt") as f:
                return f.get_tensor(key).float()
        with safe_open(st, framework="pt") as f:
            return f.get_tensor(_pick_embed_key(set(f.keys()))).float()

    idx = get("pytorch_model.bin.index.json")
    if idx is not None:
        with open(idx) as f:
            weight_map = json.load(f)["weight_map"]
        key = _pick_embed_key(weight_map)
        shard = torch.load(get(weight_map[key], required=True),
                           map_location="cpu", weights_only=True)
        return shard[key].float()
    shard = torch.load(get("pytorch_model.bin", required=True),
                       map_location="cpu", weights_only=True)
    return shard[_pick_embed_key(shard)].float()


class HFEmbeddingEncoder(TextEncoder):
    """A Hugging Face tokenizer and the LM's token-embedding table
    (text2protein_tpu/text/encoder.py:208-255): the slow tokenizer first
    (the fast one when there is none), the pad token set from eos or unk,
    `add_special_tokens=False`, truncation to `max_tokens`, embeddings and
    mask padded to the token bucket. Local files only; runs on the CPU and
    returns numpy float32."""

    def __init__(self, model_name="lmsys/vicuna-7b-v1.3", max_tokens=512,
                 pad_to_bucket=64):
        import torch
        from transformers import AutoTokenizer

        self.max_tokens = max_tokens
        self.pad_to_bucket = pad_to_bucket
        try:
            self.tokenizer = AutoTokenizer.from_pretrained(model_name,
                                                           use_fast=False)
        except Exception:  # a checkpoint with a fast tokenizer only
            self.tokenizer = AutoTokenizer.from_pretrained(model_name)
        if self.tokenizer.pad_token is None:
            self.tokenizer.pad_token = (self.tokenizer.eos_token
                                        or self.tokenizer.unk_token)
        self.embed = torch.nn.Embedding.from_pretrained(
            _load_embed_table(model_name), freeze=True)
        self.dim = self.embed.embedding_dim

    def padded_width(self, captions):
        ids = self.tokenizer(list(captions), add_special_tokens=False,
                             max_length=self.max_tokens,
                             truncation=True).input_ids
        return _bucket(max(len(i) for i in ids), self.pad_to_bucket,
                       self.max_tokens)

    def encode(self, captions):
        import torch

        toks = self.tokenizer(list(captions), return_tensors="pt",
                              add_special_tokens=False,
                              max_length=self.max_tokens, padding=True,
                              truncation=True)
        with torch.no_grad():
            emb = self.embed(toks.input_ids).float().numpy()
        mask = toks.attention_mask.bool().numpy()
        t = mask.shape[1]
        tb = _bucket(t, self.pad_to_bucket, self.max_tokens)
        if tb > t:
            emb = np.pad(emb, ((0, 0), (0, tb - t), (0, 0)))
            mask = np.pad(mask, ((0, 0), (0, tb - t)))
        return emb.astype(np.float32), mask


def build_text_encoder(config) -> TextEncoder:
    """`text.encoder`: cache, hf or hash (text2protein_tpu/text/
    encoder.py:258-279). An HF encoder that cannot be built (no local
    weights or tokenizer) falls back to hash with a printed line, as the
    JAX package does."""
    tc = config.text
    kind = tc.encoder.lower()
    if kind == "cache":
        return CachedTextEncoder(tc.cache_path, pad_to_bucket=tc.pad_to_bucket,
                                 max_tokens=tc.max_tokens)
    if kind == "hf":
        try:
            return HFEmbeddingEncoder(tc.model_name,
                                      max_tokens=tc.max_tokens,
                                      pad_to_bucket=tc.pad_to_bucket)
        except Exception as e:  # weights unavailable: deterministic fallback
            print(f"[text] HF encoder unavailable ({e}); falling back to hash")
    return HashTextEncoder(
        dim=config.model.context_dim,
        max_tokens=tc.max_tokens,
        pad_to_bucket=tc.pad_to_bucket,
        seed=config.seed,
    )


def encode_captions(captions: dict, encoder: TextEncoder, out_path):
    """{pdb_id: caption} -> an npz of each id's (T_i, D) embedding rows
    (`{pid}`) and true token count (`{pid}__len`), at least one row each
    (text2protein_tpu/text/encoder.py:282-293)."""
    arrays = {}
    for pid, caption in captions.items():
        emb, mask = encoder.encode([caption])
        t = max(int(mask[0].sum()), 1)
        arrays[pid] = emb[0, :t]
        arrays[f"{pid}__len"] = np.asarray(t)
    np.savez_compressed(out_path, **arrays)
    return out_path
