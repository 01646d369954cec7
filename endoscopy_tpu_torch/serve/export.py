"""Export the eval forward for serving (port of ``endoscopy_tpu/serve/export.py``).

The JAX package lowers the forward to StableHLO; the port ships a
port-owned artifact instead: ``torch.save`` of ``{format, arch,
num_classes, img_size, input_size, dtype, batch, state_dict}``, loaded back
with ``weights_only=True`` (tensors and plain values only, no pickled
code). Serving rebuilds the model from ``arch`` and runs the same eval
forward: canonical uint8 NHWC → center crop + ImageNet normalize → backbone
→ head → float32 softmax.

``quantize="int8"`` stores the weight-only int8 kernels and their scales
(``serve/quantize.py``) and records the mode as ``quantize``;
:func:`load_exported` dequantizes them once, at load, into the serving
dtype (bf16 on the card), so the forward is the unquantized one on the
dequantized weights, the numbers the JAX artifact computes when XLA folds
the same convert × scale into its constants. An artifact without the key
(the first format) loads as before.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from endoscopy_tpu_torch.aug.views import eval_view
from endoscopy_tpu_torch.config.loader import default_config
from endoscopy_tpu_torch.data.pipeline import canonical_size
from endoscopy_tpu_torch.device import resolve_device, resolve_dtype
from endoscopy_tpu_torch.models import build_model
from endoscopy_tpu_torch.serve.quantize import (dequantize_state_dict,
                                                quantize_state_dict)

FORMAT = "endoscopy_tpu_torch.serve/1"


def make_infer_fn(model: torch.nn.Module, img_size: int, dtype: str = "bfloat16",
                  device=None):
    """Closure over the model: canonical uint8 batch → float32 softmax
    probabilities as a numpy array. ``dtype`` is the config's compute
    dtype: bf16 autocast on the card, float32 always on the CPU."""
    dev = resolve_device(device)
    cdtype = resolve_dtype(dev, dtype)
    model = model.to(dev).eval()
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    @torch.inference_mode()
    def infer(batch_u8) -> np.ndarray:
        x = eval_view(batch_u8, img_size, cdtype, device=dev)
        x = x.permute(0, 3, 1, 2)  # NCHW shape, channels_last strides
        with torch.autocast(device_type=dev.type, dtype=torch.bfloat16,
                            enabled=cdtype == torch.bfloat16):
            logits = model(x)
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
    config = default_config({"MODEL": {"NAME": art["arch"],
                                       "NUM_CLASSES": art["num_classes"]}})
    model = build_model(config)
    state = art["state_dict"]
    quantize = art.get("quantize")
    _check_quantize(quantize)
    if quantize:
        dev = resolve_device(device)
        state = dequantize_state_dict(state, resolve_dtype(dev, art["dtype"]))
    model.load_state_dict(state, strict=True)
    infer = make_infer_fn(model, art["img_size"], art["dtype"], device)
    infer.input_size = int(art["input_size"])
    infer.num_classes = int(art["num_classes"])
    infer.batch = art["batch"]
    infer.quantize = quantize
    return infer
