"""Config: attribute-access dict with the JAX package's schema and defaults.

Counterpart of text2protein_tpu/config.py. YAML files are read by
`parse_yaml`, a reader of the YAML subset the repo's `configs/*.yml` use
(PyYAML is not a dependency of the port); `flagship_config` and
`bench_l128_config` build the L=128 configs in Python, `quality_n256_config`
reads configs/quality_n256.yml as written.
"""

from __future__ import annotations

import copy
import math
import re
from pathlib import Path

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


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
        "eval_freq": 100,
        "snapshot_freq_for_preemption": 10_000,
        "snapshot_sampling": False,
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
        "dataset_path": "",
        "caption_path": "",
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
        "init_scale": 0.0,
        "inpainting": {
            "random_mask_prob": 0.33,
            "contiguous_mask_prob": 0.33,
            "mask_min_len": 0.05,
            "mask_max_len": 0.95,
        },
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
    # the ('data', 'model') mesh of ranks (parallel/mesh.py): data -1 means
    # every rank that model leaves
    "mesh": {
        "data": -1,
        "model": 1,
    },
    "text": {
        "encoder": "hash",  # hash | cache | hf
        "model_name": "lmsys/vicuna-7b-v1.3",
        "cache_path": "",
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


_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)")
# YAML 1.1's float: a dot is required ("1e-4" is a string, as in PyYAML)
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?")
_BOOL = {"true": True, "yes": True, "on": True,
         "false": False, "no": False, "off": False}


def _scalar(text: str):
    s = text.strip()
    if s in ("", "~", "null", "Null", "NULL"):
        return None
    if s == "[]":
        return []
    if s == "{}":
        return {}
    if len(s) >= 2 and s[0] in "'\"" and s[-1] == s[0]:
        return s[1:-1]
    if s.lower() in _BOOL and s in (s.lower(), s.capitalize(), s.upper()):
        return _BOOL[s.lower()]
    if _INT.fullmatch(s):
        return int(s.replace("_", ""))
    if _FLOAT.fullmatch(s) and s not in (".", "+.", "-."):
        return float(s.replace("_", ""))
    return s


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_yaml(text: str) -> dict:
    """The YAML subset of the repo's configs: nested block mappings, block
    lists of scalars (at the key's indentation or deeper), `[]`, quoted
    strings, comments, and YAML 1.1 scalars as PyYAML resolves them (ints,
    floats with a dot, true/false/yes/no/on/off, null)."""
    lines = []
    for raw in text.splitlines():
        body = _strip_comment(raw).rstrip()
        if body.strip():
            lines.append((len(body) - len(body.lstrip(" ")), body.strip()))

    def block(i, indent):
        if lines[i][1].startswith("-"):
            out = []
            while (i < len(lines) and lines[i][0] == indent
                   and lines[i][1].startswith("-")):
                out.append(_scalar(lines[i][1][1:]))
                i += 1
            return out, i
        out = {}
        while i < len(lines) and lines[i][0] == indent:
            key, sep, rest = lines[i][1].partition(":")
            if not sep:
                raise ValueError(f"not a mapping entry: {lines[i][1]!r}")
            key = key.strip()
            if len(key) >= 2 and key[0] in "'\"" and key[-1] == key[0]:
                key = key[1:-1]
            i += 1
            if rest.strip():
                out[key] = _scalar(rest)
            elif i < len(lines) and (
                    lines[i][0] > indent
                    or (lines[i][0] == indent
                        and lines[i][1].startswith("-"))):
                out[key], i = block(i, lines[i][0])
            else:
                out[key] = None
        return out, i

    if not lines:
        return {}
    out, i = block(0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unparsed YAML from {lines[i][1]!r}")
    return out


def load_config(path_or_dict) -> ConfigDict:
    """Load a YAML config file (or dict) and apply the defaults."""
    if isinstance(path_or_dict, dict):
        user = dict(path_or_dict)
    else:
        user = parse_yaml(Path(path_or_dict).read_text()) or {}
    cfg = ConfigDict(_merge(copy.deepcopy(_DEFAULTS), user))
    validate_config(cfg)
    return cfg


# a string written without quotes: letters, digits and a few marks
_PLAIN = re.compile(r"[A-Za-z_./][A-Za-z0-9_./-]*")


def _yaml_scalar(v, nonfinite=False) -> str:
    """`v` as a YAML 1.1 scalar that `_scalar` (and PyYAML) read back as
    the same value; with `nonfinite`, nan and inf as PyYAML writes them
    (`.nan`, `.inf`, `-.inf`), which only PyYAML reads back."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            if not nonfinite:
                raise ValueError(f"cannot write the float {v} as YAML")
            return ".nan" if v != v else ("-.inf" if v < 0 else ".inf")
        text = repr(v)
        if "." not in text:  # YAML 1.1 reads a float only with a dot
            mant, _, exp = text.partition("e")
            text = f"{mant}.0" + (f"e{exp}" if exp else "")
        if "e" in text and text.split("e")[1][0] not in "+-":
            text = text.replace("e", "e+")
        return text
    if isinstance(v, str):
        if _PLAIN.fullmatch(v) and _scalar(v) == v:
            return v
        if "\n" not in v and '"' not in v and "\\" not in v:
            return f'"{v}"'
        if "\n" not in v and "'" not in v:
            return f"'{v}'"
        raise ValueError(f"cannot write the string {v!r} as YAML")
    raise TypeError(f"cannot write {type(v).__name__} {v!r} as YAML")


def _yaml_lines(d: dict, indent: int, nonfinite: bool) -> list:
    lines, pad = [], " " * indent
    for k, v in d.items():
        k = _yaml_scalar(str(k))  # a key that would read as a number quoted
        if isinstance(v, dict):
            if v:
                lines.append(f"{pad}{k}:")
                lines += _yaml_lines(v, indent + 2, nonfinite)
            else:
                lines.append(f"{pad}{k}: {{}}")
        elif isinstance(v, (list, tuple)):
            if v:
                lines.append(f"{pad}{k}:")
                lines += [f"{pad}- {_yaml_scalar(i, nonfinite)}" for i in v]
            else:
                lines.append(f"{pad}{k}: []")
        else:
            lines.append(f"{pad}{k}: {_yaml_scalar(v, nonfinite)}")
    return lines


def dump_yaml(data: dict, nonfinite: bool = False) -> str:
    """`data` (nested mappings with string keys, block lists of scalars)
    as YAML that PyYAML reads back equal, and `parse_yaml` too unless a
    non-finite float was written (`nonfinite`)."""
    return "\n".join(_yaml_lines(data, 0, nonfinite)) + "\n"


def save_config(cfg, path) -> None:
    """Write `cfg` as YAML that `parse_yaml` (and PyYAML) read back equal:
    nested mappings, block lists of scalars, scalars quoted where they
    would read as something else."""
    data = cfg.to_dict() if isinstance(cfg, ConfigDict) else dict(cfg)
    Path(path).write_text(dump_yaml(data))


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
    """Raise rather than build a different model without a word: the JAX
    `build_model` takes `model.dtype` and `model.norm_dtype` float32 or
    bfloat16 (and raises KeyError on any other); so does the port, with
    NotImplementedError naming the key."""
    m = cfg.model
    for key in ("dtype", "norm_dtype"):
        value = str(m.get(key, "float32"))
        if value not in ("float32", "bfloat16"):
            raise NotImplementedError(
                f"model.{key}: {value} is not a dtype of the model; float32 "
                "or bfloat16")


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
    cfg.data.dataset_path = "./data/pdbs"
    cfg.data.caption_path = "./data/captions.json"
    cfg.data.processed_dataset_path = "./data/processed"
    return cfg


def quality_n256_config() -> ConfigDict:
    """configs/quality_n256.yml as written: the reference-flagship-scale
    model (N=256, nf=256, attention at 32, 16 and 8, context 4096) in bf16
    with remat of the residual blocks, on-device featurization, batch 8."""
    return load_config(CONFIGS / "quality_n256.yml")


def quality_ss_config() -> ConfigDict:
    """configs/quality_ss.yml as written: the flagship L=128 widths
    conditioned on length, SS blocks and inpainting (C=8, featurization on
    the device, a 16-token caption), float32, batch 16."""
    return load_config(CONFIGS / "quality_ss.yml")


def quality_ss_vp_config() -> ConfigDict:
    """configs/quality_ss_vp.yml as written: quality_ss.yml computed in
    bf16."""
    return load_config(CONFIGS / "quality_ss_vp.yml")
