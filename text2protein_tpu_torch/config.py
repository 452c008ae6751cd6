"""Config: attribute-access dict with the JAX package's schema and defaults.

Counterpart of text2protein_tpu/config.py. The GPU machine has no PyYAML, so
the flagship configs are built in Python (`flagship_config`,
`bench_l128_config`) and `yaml` is imported only when a YAML file is loaded.
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
    "training": {
        "sde": "vesde",
        "n_iters": 1_000_000,
        "batch_size": 8,
        "log_freq": 50,
        "epochs": 1000,
    },
    "sampling": {
        "n_steps_each": 1,
        "noise_removal": True,
        "probability_flow": False,
        "snr": 0.17,
        "method": "pc",
        "predictor": "reverse_diffusion",
        "corrector": "langevin",
    },
    "data": {
        "processed_dataset_path": "",
        "min_res_num": 40,
        "max_res_num": 128,
        "num_channels": 5,
    },
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
        "ema_rate": 0.999,
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
    "optim": {
        "weight_decay": 0,
        "optimizer": "Adam",
        "lr": 1e-4,
        "beta1": 0.9,
        "eps": 1e-8,
        "warmup": 5000,
        "grad_clip": 1.0,
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


def check_ported_model(cfg: ConfigDict) -> None:
    """Raise NotImplementedError for a model setting the port does not
    compute yet, rather than building a different model without a word.

    - `model.dtype` other than float32: the port computes the UNet in f32.
    - `model.remat_resblocks: true`: the port keeps every activation.
    - `model.norm_dtype: bfloat16` is accepted, since `model.dtype` is then
      float32: the JAX GroupNorm with `follow_input_dtype` normalizes in the
      input's dtype (text2protein_tpu/models/layers.py, `apply_dtype =
      x.dtype`), and in an f32 network that is f32, the function the port
      computes. Its statistics are f32 in both modes.
    """
    m = cfg.model
    dtype = str(m.get("dtype", "float32"))
    if dtype != "float32":
        raise NotImplementedError(
            f"model.dtype: {dtype} is not ported yet; the port computes the "
            "model in float32")
    if m.get("remat_resblocks", False):
        raise NotImplementedError(
            "model.remat_resblocks: true is not ported yet; the port keeps "
            "every activation for the backward")
    norm = str(m.get("norm_dtype", "float32"))
    if norm not in ("float32", "bfloat16"):
        raise ValueError(f"unknown model.norm_dtype {norm}")


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


def bench_l128_config() -> ConfigDict:
    """configs/bench_l128.yml as the port reads it: the flagship widths with
    its training settings (batch 16, dropout 0.1, and the defaults' Adam lr
    1e-4 with 5000 warmup steps and clip 1.0, EMA 0.999), computed in
    float32. The yml's `norm_dtype: bfloat16` is left out: with
    `model.dtype` float32 it is the same function (`check_ported_model`)."""
    cfg = flagship_config()
    cfg.training.batch_size = 16
    cfg.data.processed_dataset_path = "./data/processed"
    return cfg
