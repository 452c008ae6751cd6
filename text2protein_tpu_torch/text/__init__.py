from .encoder import (
    CachedTextEncoder,
    HashTextEncoder,
    HFEmbeddingEncoder,
    TextEncoder,
    build_text_encoder,
    encode_captions,
)
