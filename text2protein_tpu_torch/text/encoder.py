"""Caption -> (B, T, D) context embeddings (counterpart of
text2protein_tpu/text/encoder.py:32-102,258-280).

Only the hashed-token encoder is ported so far; the cached and Hugging Face
encoders come later. It is numpy code, kept here as a copy so that the port
does not import the JAX package.
"""

from __future__ import annotations

import hashlib
import re

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


def build_text_encoder(config) -> TextEncoder:
    tc = config.text
    kind = tc.encoder.lower()
    if kind != "hash":
        raise NotImplementedError(
            f"text.encoder={kind} is not ported yet; use hash")
    return HashTextEncoder(
        dim=config.model.context_dim,
        max_tokens=tc.max_tokens,
        pad_to_bucket=tc.pad_to_bucket,
        seed=config.seed,
    )
