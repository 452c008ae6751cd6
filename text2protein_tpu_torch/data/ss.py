"""Secondary-structure block spans (counterpart of
text2protein_tpu/data/ss.py:`parse_ss_spans`). The P-SEA annotation and the
coarse SS constraints wait for the C=8 training path."""

from __future__ import annotations

import numpy as np


def parse_ss_spans(ss_indices: str, max_blocks: int) -> np.ndarray:
    """An "s:e,s:e" block string -> a (max_blocks, 2) int32 array, padded
    with -1."""
    spans = np.full((max_blocks, 2), -1, dtype=np.int32)
    if ss_indices:
        for i, tok in enumerate(ss_indices.split(",")[:max_blocks]):
            s, e = tok.split(":")
            spans[i] = (int(s), int(e))
    return spans
