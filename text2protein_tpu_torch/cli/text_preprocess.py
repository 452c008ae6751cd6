"""Caption-embedding cache writer (counterpart of
text2protein_tpu/cli/text_preprocess.py).

Reads `data.caption_path` (a JSON object pdb id -> caption, or a list of
{pdb_id, caption}), encodes each caption with the config's text encoder and
writes the npz that `text.encoder: cache` reads (`text/encoder.
encode_captions`). Runs on the CPU.

Usage:
  python -m text2protein_tpu_torch.cli.text_preprocess CONFIG
      [--out id2emb.npz] [--limit N]
"""

from __future__ import annotations

import argparse
import json

from ..config import load_config
from ..text.encoder import build_text_encoder, encode_captions


def main(argv=None):
    """Write the cache; returns its path."""
    p = argparse.ArgumentParser(description="Build the caption cache")
    p.add_argument("config", type=str)
    p.add_argument("--out", type=str, default="id2emb.npz")
    p.add_argument("--limit", type=int, default=None,
                   help="encode only the first N captions")
    args = p.parse_args(argv)

    config = load_config(args.config)
    with open(config.data.caption_path) as f:
        ann = json.load(f)
    if not isinstance(ann, dict):
        ann = {a["pdb_id"]: a["caption"] for a in ann}
    if args.limit:
        ann = dict(list(ann.items())[:args.limit])
    out = encode_captions(ann, build_text_encoder(config), args.out)
    print(f"wrote {len(ann)} caption embeddings to {out}")
    return out


if __name__ == "__main__":
    main()
