"""Serving for the port: a torch artifact of the eval forward and the
bucket-batching HTTP server."""

from endoscopy_tpu_torch.serve.export import (export_model, load_exported,
                                              make_infer_fn)

__all__ = ["export_model", "load_exported", "make_infer_fn"]
