"""CoMatch's carried state (port of ``endoscopy_tpu/ssl_state/comatch_state.py``).

- The memory bank: ``queue_feats`` (queue_size, low_dim) and
  ``queue_probs`` (queue_size, num_classes), a ring with the pointer
  ``queue_ptr``; the trainer writes it under the reference's ``n ==
  queue_size`` gate.
- Distribution alignment: the trailing 32 batch-mean probability vectors
  as a fixed (32, num_classes) ring ``da_buffer`` with its pointer
  ``da_ptr`` and fill count ``da_count``, averaged over the filled rows.

Every field is a tensor on the trainer's device (the pointers and the
count 0-d int64), so a step reads and writes them without a host round
trip. Checkpoints do not hold this state, as the JAX package's do not
(``train/common.py``): a resume starts it fresh.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class CoMatchState:
    queue_feats: torch.Tensor  # (queue_size, low_dim)
    queue_probs: torch.Tensor  # (queue_size, num_classes)
    queue_ptr: torch.Tensor    # () int64
    da_buffer: torch.Tensor    # (da_len, num_classes)
    da_ptr: torch.Tensor       # () int64
    da_count: torch.Tensor     # () int64


def comatch_state_init(queue_size: int, low_dim: int, num_classes: int,
                       device, da_len: int = 32) -> CoMatchState:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return CoMatchState(
        queue_feats=zeros(queue_size, low_dim),
        queue_probs=zeros(queue_size, num_classes),
        queue_ptr=zeros(dtype=torch.long),
        da_buffer=zeros(da_len, num_classes),
        da_ptr=zeros(dtype=torch.long),
        da_count=zeros(dtype=torch.long))
