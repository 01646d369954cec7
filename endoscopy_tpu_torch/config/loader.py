"""YAML → nested AttrDict config (copy of ``endoscopy_tpu/config/loader.py``).

Same contract and defaults as the JAX package, including
``DATA.CANONICAL_SCALE = 1.2``. ``yaml`` is imported only by the function
that reads a file: a config can also be built from a plain dict
(``AttrDict(_deep_merge(_DEFAULTS, {...}))`` via :func:`default_config`).
"""

from __future__ import annotations

from typing import Any, Mapping


class AttrDict(dict):
    """dict with attribute access, recursively wrapping nested mappings."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        for key, value in list(self.items()):
            if isinstance(value, Mapping) and not isinstance(value, AttrDict):
                self[key] = AttrDict(value)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, AttrDict):
            value = AttrDict(value)
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def copy(self) -> "AttrDict":
        return AttrDict({
            k: (v.copy() if isinstance(v, AttrDict) else v) for k, v in self.items()
        })


def is_none(value: Any) -> bool:
    """True for Python None and the YAML-string ``'None'``."""
    return value is None or value == "None"


def load_yaml(path: str) -> AttrDict:
    import yaml  # only the file path needs PyYAML

    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return AttrDict(raw or {})


def _deep_merge(base: dict, override: Mapping) -> dict:
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], Mapping) and isinstance(value, Mapping):
            out[key] = _deep_merge(dict(out[key]), value)
        else:
            out[key] = value
    return out


# Defaults for knobs that reference configs sometimes omit but code reads
# (the JAX package's _DEFAULTS, unchanged).
_DEFAULTS: dict = {
    "DATA": {
        "IMG_SIZE": 224,
        "BATCH_SIZE": 32,
        "NUM_WORKERS": 2,
        "MOCKUP_SSL": True,
        "MU": 7,
        "INPUT_NAME": "image",
        "TARGET_NAME": "target",
        "IS_CROP": True,
        "CANONICAL_SCALE": 1.2,
        "LOADER": "python",
        "IS_REPROD": False,
    },
    "MODEL": {
        "NUM_CLASSES": 6,
        "NAME": "resnet50",
        "PRE_TRAIN": False,
        "PRE_TRAIN_PATH": "None",
        "PRE_TRAIN_RESUME": "None",
        "MARGIN": "None",
        "TYPE_SEMI": "FixMatch",
        "IS_TRIPLET": False,
        "LOW_DIM": 128,
    },
    "TRAIN": {
        "IS_FREEZE": False,
        "IS_SSL": False,
        "EPOCHS": 100,
        "BASE_LR": 1e-3,
        "WARMUP_LR": 5e-4,
        "WEIGHT_DECAY": 1e-5,
        "WARMUP_EPOCHS": 5,
        "DECAY_EPOCHS": 10,
        "OPT_NAME": "Adam",
        "EPS": 1e-8,
        "BETAS": [0.9, 0.999],
        "MOMENTUM": 0.9,
        "FREQ_EVAL": 5,
        "SCH_NAME": "step",
        "LR_DECAY": 0.8,
        "USE_EMA": True,
        "EMA_DECAY": 0.999,
        "EVAL_STEP": 512,
        "EVAL_STEP_SUP": 15,
        "CLS_WEIGHT": True,
        "THRES": 0.7,
        "T": 1.0,
        "LAMBDA_U": 2.0,
        "LAMBDA_C": 4.0,
        "SAVE_CP": "./checkpoints",
        "TRAIN_RULE": "None",
        "EXPANSION": "balance",
        "MIXUP": 0.0,
        "CUTMIX": 0.0,
        "CUTMIX_MINMAX": "None",
        "MIXUP_PROB": 1.0,
        "MIXUP_SWITCH_PROB": 0.5,
        "MIXUP_MODE": "batch",
        "LABEL_SMOOTHING": 0.1,
        "MESH_DATA": -1,
        "MESH_MODEL": 1,
        "DTYPE": "bfloat16",
        "SEED": 42,
        "STEPS_PER_CALL": 8,
        "GRAD_ACCUM": 1,
        "LOG_DIR": "",
        "USE_WANDB": False,
    },
}


def get_config(path: str) -> AttrDict:
    """Load a YAML preset and merge it over the defaults."""
    return AttrDict(_deep_merge(_DEFAULTS, load_yaml(path)))


def default_config(overrides: Mapping | None = None) -> AttrDict:
    """The defaults, optionally merged with a nested dict of overrides."""
    return AttrDict(_deep_merge(_DEFAULTS, overrides or {}))
