"""Config: attribute-access dict with the JAX package's schema and defaults.

Counterpart of text2protein_tpu/config.py. The GPU machine has no PyYAML, so
the flagship config is built in Python (`flagship_config`) and `yaml` is
imported only when a YAML file is loaded.
"""

from __future__ import annotations

import copy


class ConfigDict(dict):
    """A dict with attribute access, recursively applied."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, v):
        if isinstance(v, dict):
            return cls(v)
        if isinstance(v, (list, tuple)):
            return [cls._wrap(i) for i in v]
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)

    def __deepcopy__(self, memo):
        return ConfigDict(copy.deepcopy(dict(self), memo))

    def to_dict(self):
        out = {}
        for k, v in self.items():
            if isinstance(v, ConfigDict):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [i.to_dict() if isinstance(i, ConfigDict) else i
                          for i in v]
            else:
                out[k] = v
        return out


# The keys the port reads, with the JAX package's defaults
# (text2protein_tpu/config.py `_DEFAULTS`).
_DEFAULTS = {
    "training": {"sde": "vesde", "batch_size": 8},
    "sampling": {
        "n_steps_each": 1,
        "noise_removal": True,
        "probability_flow": False,
        "snr": 0.17,
        "method": "pc",
        "predictor": "reverse_diffusion",
        "corrector": "langevin",
    },
    "data": {"min_res_num": 40, "max_res_num": 128, "num_channels": 5},
    "model": {
        "condition": [],
        "sigma_max": 100.0,
        "sigma_min": 0.01,
        "num_scales": 2000,
        "beta_min": 0.1,
        "beta_max": 20.0,
        "dropout": 0.1,
        "name": "ncsnpp",
        "scale_by_sigma": True,
        "nonlinearity": "swish",
        "nf": 128,
        "ch_mult": [1, 1, 2, 2, 2, 2],
        "num_res_blocks": 2,
        "attn_resolutions": [16],
        "skip_rescale": True,
        "resblock_type": "biggan",
        "n_heads": 8,
        "context_dim": 4096,
    },
    "text": {
        "encoder": "hash",
        "max_tokens": 512,
        "pad_to_bucket": 64,
    },
    "seed": 42,
}


def _merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v
    return dst


def load_config(path_or_dict) -> ConfigDict:
    """Load a YAML config file (or dict) and apply the defaults."""
    if isinstance(path_or_dict, dict):
        user = dict(path_or_dict)
    else:
        import yaml

        with open(path_or_dict) as f:
            user = yaml.safe_load(f) or {}
    cfg = ConfigDict(_merge(copy.deepcopy(_DEFAULTS), user))
    validate_config(cfg)
    return cfg


def validate_config(cfg: ConfigDict) -> None:
    if cfg.training.sde not in ("vesde", "vpsde", "subvpsde"):
        raise ValueError(f"unknown sde {cfg.training.sde}")
    if cfg.data.num_channels not in (5, 8):
        raise ValueError("num_channels must be 5 (no SS) or 8 (with SS "
                         f"block channels); got {cfg.data.num_channels}")
    n, levels = cfg.data.max_res_num, len(cfg.model.ch_mult)
    if n % (2 ** (levels - 1)):
        raise ValueError(f"max_res_num={n} must be divisible by "
                         f"2**(len(ch_mult)-1)={2 ** (levels - 1)}")
    for c in cfg.model.condition:
        if c not in ("length", "ss", "inpainting"):
            raise ValueError(f"unknown condition {c}")
    if "ss" in cfg.model.condition and cfg.data.num_channels != 8:
        raise ValueError("ss conditioning needs 8 channels")


def flagship_config() -> ConfigDict:
    """The flagship L=128 text-conditioned model: the widths of
    configs/bench_l128.yml, as the JAX package's `__graft_entry__` builds
    them, computed in float32."""
    return load_config({
        "training": {"sde": "vesde", "batch_size": 2},
        "data": {"max_res_num": 128, "num_channels": 5},
        "model": {
            "condition": ["length"],
            "nf": 128,
            "ch_mult": [1, 1, 2, 2, 2, 2],
            "num_res_blocks": 2,
            "attn_resolutions": [16],
            "n_heads": 8,
            "context_dim": 512,
            "dropout": 0.1,
        },
        "text": {"encoder": "hash", "pad_to_bucket": 64},
    })
