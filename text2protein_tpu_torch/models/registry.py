"""Model registry (counterpart of text2protein_tpu/models/registry.py)."""

from __future__ import annotations

_MODELS = {}


def register_model(cls=None, *, name=None):
    def _register(c):
        local = name or c.__name__
        if local in _MODELS:
            raise ValueError(f"Already registered model with name: {local}")
        _MODELS[local] = c
        return c

    return _register if cls is None else _register(cls)


def get_model(name: str):
    return _MODELS[name]
