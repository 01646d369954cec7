"""Port: the CUDA RandAugment kernel against its plain version, on the card.

Needs an NVIDIA card and nvcc: the kernel has no CPU mode, so these tests
skip elsewhere. The file imports no JAX, so the card's machine runs it
without the JAX package's test configuration:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_port_kernel_cuda.py
"""

import pytest
import torch

from endoscopy_tpu_torch.aug import randaugment as tra
from endoscopy_tpu_torch.ops import randaugment_kernel as tk

torch.set_num_threads(1)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Every op forced into slot 1 (twice), crop-fused and plain mode, f32
    and bf16 I/O; and a strided input: the same pixels as the plain
    version, one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernel has no CPU mode")
    tk.build()
    for crop in (None, 64):
        for dtype in (torch.float32, torch.bfloat16):
            _forced_ops_match_plain(crop, dtype)
    _strided_input_is_read_through_its_strides()


def _forced_ops_match_plain(crop, dtype):
    gen = torch.Generator().manual_seed(0)
    b, size, pad = 2 * tra.NUM_OPS, 64, 8
    side = size + 2 * pad if crop else size
    x = torch.randint(0, 256, (b, side, side, 3), generator=gen).to(dtype)
    pi, pf = tra.sample_randaugment_params(gen, b, size, size)
    pi[:, 2] = torch.arange(b) % tra.NUM_OPS
    pi[:, 3] = 1
    if crop:
        offs = torch.randint(0, 2 * pad + 1, (b, 2), generator=gen)
        pi = torch.cat([pi, offs.to(torch.int32)], dim=1)
    x, pi, pf = x.cuda(), pi.cuda(), pf.cuda()
    before = tk.randaugment_mc.launches
    got = tk.randaugment_mc(x, pi, pf, crop)
    torch.cuda.synchronize()
    assert tk.randaugment_mc.launches == before + 1
    assert torch.equal(got, tra.randaugment_mc_plain(x, pi, pf, crop)), (
        f"crop={crop} dtype={dtype}")


def _strided_input_is_read_through_its_strides():
    """A non-contiguous NHWC view (a window of a larger batch)."""
    gen = torch.Generator().manual_seed(1)
    big = torch.randint(0, 256, (4, 40, 40, 3), generator=gen).float().cuda()
    x = big[:, 4:36, 4:36]
    pi, pf = tra.sample_randaugment_params(gen, 4, 32, 32)
    pi, pf = pi.cuda(), pf.cuda()
    got = tk.randaugment_mc(x, pi, pf)
    assert torch.equal(got, tk.randaugment_mc(x.contiguous(), pi, pf))
    assert torch.equal(got, tra.randaugment_mc_plain(x, pi, pf))
