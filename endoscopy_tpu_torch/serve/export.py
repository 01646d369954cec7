"""Export the eval forward for serving (port of ``endoscopy_tpu/serve/export.py``).

The JAX package lowers the forward to StableHLO; the port ships a
port-owned artifact instead: ``torch.save`` of ``{format, arch,
num_classes, img_size, input_size, dtype, batch, quantize, is_reprod,
model, state_dict}``,
loaded back with ``weights_only=True`` (tensors and plain values only, no
pickled code). Serving rebuilds the model from ``arch``, the ``MODEL``
fields that shape it (``model``: the wrapper's ``TYPE_SEMI``,
``IS_TRIPLET``, ``LOW_DIM``, ``MARGIN``, and the Conformer's
``EMBED_DIM``, ``DEPTH``, ...) and ``img_size`` (``DATA.IMG_SIZE``: the
side-sized backbones, SASA's encodings, Swin's windows, CoAtNet's tables,
ViT-LSA's position embedding, are built for it), and runs the same eval
forward: canonical uint8 NHWC → center crop + ImageNet normalize (under
``is_reprod``, a model trained with ``DATA.IS_REPROD``: resize + the mean
= std = 0.5 normalize) → backbone → head → float32 softmax. A model with
several outputs serves its first (``models/heads.py::model_logits``):
``ModelwEmb``'s logits, the Conformer's conv head alone, as the JAX export
does. An artifact
without ``model`` (written before it) rebuilds from ``arch`` and
``num_classes`` as it did.

``quantize="int8"`` stores the weight-only int8 kernels and their scales
(``serve/quantize.py``) and records the mode as ``quantize``;
:func:`load_exported` dequantizes them once, at load, into the serving
dtype (bf16 on the card), so the forward is the unquantized one on the
dequantized weights, the numbers the JAX artifact computes when XLA folds
the same convert × scale into its constants. An artifact without one of
these keys (an earlier format) loads as before.

"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from endoscopy_tpu_torch.aug.views import eval_view, reproduce_eval_view
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.data.pipeline import canonical_size
from endoscopy_tpu_torch.device import resolve_device, resolve_dtype
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.models.heads import model_logits
from endoscopy_tpu_torch.models.registry import CONFORMER_FIELDS
from endoscopy_tpu_torch.serve.quantize import (dequantize_state_dict,
                                                quantize_state_dict)

FORMAT = "endoscopy_tpu_torch.serve/1"
# the MODEL fields besides NAME and NUM_CLASSES that shape the built model
MODEL_FIELDS = ("TYPE_SEMI", "IS_TRIPLET", "LOW_DIM", "MARGIN",
                *(key for key, _ in CONFORMER_FIELDS))


def make_infer_fn(model: torch.nn.Module, img_size: int, dtype: str = "bfloat16",
                  device=None, is_reprod: bool = False):
    """Closure over the model: canonical uint8 batch → float32 softmax
    probabilities as a numpy array. ``dtype`` is the config's compute
    dtype: bf16 autocast on the card, float32 always on the CPU.
    ``is_reprod`` takes the paper-reproduction eval view (resize and the
    mean = std = 0.5 normalize) in place of the center crop and
    ImageNet's normalize, as a model trained under ``DATA.IS_REPROD`` was
    evaluated."""
    dev = resolve_device(device)
    view = reproduce_eval_view if is_reprod else eval_view
    cdtype = resolve_dtype(dev, dtype)
    model = model.to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    @torch.inference_mode()
    def infer(batch_u8) -> np.ndarray:
        x = view(batch_u8, img_size, cdtype, device=dev)
        x = x.permute(0, 3, 1, 2)  # NCHW shape, channels_last strides
        with torch.autocast(device_type=dev.type, dtype=torch.bfloat16,
                            enabled=cdtype == torch.bfloat16):
            logits = model_logits(model(x))
        return torch.softmax(logits.float(), dim=-1).cpu().numpy()

    return infer


def _check_quantize(quantize: str | None) -> None:
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r} "
                         "(supported: 'int8')")


def export_model(config, state_dict: Mapping[str, torch.Tensor], out_path: str,
                 batch: int | None = None,
                 quantize: str | None = None) -> Tuple[int, int]:
    """Write the serving artifact for ``config``'s model with the given
    weights (checked with a strict ``load_state_dict``). ``batch=None``
    serves any batch size; an int pins it. ``quantize="int8"`` stores the
    kernels as int8 with per-channel scales. Returns
    ``(canonical_input_size, num_classes)``."""
    _check_quantize(quantize)
    model = build_model(config)
    model.load_state_dict(state_dict, strict=True)
    size = canonical_size(config)
    artifact = {
        "format": FORMAT,
        "arch": str(config.MODEL.NAME),
        "num_classes": int(config.MODEL.NUM_CLASSES),
        "img_size": int(config.DATA.IMG_SIZE),
        "input_size": int(size),
        "dtype": str(config.TRAIN.get("DTYPE", "bfloat16")),
        "batch": None if batch is None else int(batch),
        "quantize": quantize,
        "is_reprod": bool(config.DATA.get("IS_REPROD", False)),
        "model": {key: config.MODEL[key] for key in MODEL_FIELDS
                  if key in config.MODEL},
        "state_dict": (quantize_state_dict(model) if quantize else
                       {k: v.detach().cpu()
                        for k, v in model.state_dict().items()}),
    }
    torch.save(artifact, out_path)
    return size, int(config.MODEL.NUM_CLASSES)


def load_exported(path: str, device=None):
    """Load an artifact → ``fn(batch_u8) -> probs`` on ``device``, carrying
    the artifact's contract as attributes: ``input_size``, ``num_classes``,
    ``batch`` (pinned size, or None) and ``quantize`` (None or ``int8``)."""
    art = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(art, dict) or art.get("format") != FORMAT:
        raise ValueError(f"{path} is not an {FORMAT} artifact")
    config = default_config({
        "MODEL": {"NAME": art["arch"], "NUM_CLASSES": art["num_classes"],
                  **art.get("model", {})},
        "DATA": {"IMG_SIZE": art["img_size"]}})
    model = build_model(config)
    state = art["state_dict"]
    quantize = art.get("quantize")
    _check_quantize(quantize)
    if quantize:
        dev = resolve_device(device)
        state = dequantize_state_dict(state, resolve_dtype(dev, art["dtype"]))
    model.load_state_dict(state, strict=True)
    infer = make_infer_fn(model, art["img_size"], art["dtype"], device,
                          is_reprod=bool(art.get("is_reprod", False)))
    infer.input_size = int(art["input_size"])
    infer.num_classes = int(art["num_classes"])
    infer.batch = art["batch"]
    infer.quantize = quantize
    return infer
