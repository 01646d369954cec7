"""Port: the CUDA kernels (RandAugment, the JPEG route's resize) against
their plain versions, on the card.

Needs an NVIDIA card and nvcc: the kernel has no CPU mode, so these tests
skip elsewhere. The file imports no JAX, so the card's machine runs it
without the JAX package's test configuration:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_port_kernel_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

from endoscopy_tpu_torch.aug import ops
from endoscopy_tpu_torch.aug import randaugment as tra
from endoscopy_tpu_torch.aug import views
from endoscopy_tpu_torch.data import jpeg_card
from endoscopy_tpu_torch.ops import randaugment_kernel as tk
from endoscopy_tpu_torch.train.common import BaseTrainer
from endoscopy_tpu_torch.utils import trace
from endoscopy_tpu_torch.utils.meters import AverageMeter
from torch_port_checks import path_l, path_o

torch.set_num_threads(1)

# the cluster size each side takes: the configured sides, 37 (rows that do
# not split evenly over the cluster's blocks) and 260 (clusters of 8, rows
# 33 per block and 29 in the last)
CLUSTER_OF_SIDE = {32: 2, 37: 2, 112: 2, 224: 4, 260: 8}


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Every op forced into slot 1 (sampled magnitude, then v = 9 with both
    signs, then after color), at every configured side and an odd one, f32
    and bf16 I/O, in plain mode, crop mode with pad = 0 and crop mode with
    pad > 0: the same pixels as the plain version, one launch counted per
    call. The sides take every cluster size (2, 4 and 8 blocks). Then a
    strided input, a side above the kernel's limit, one FixMatch training
    step through the kernel on the card against the CPU, and one
    supervised step of each branch (no kernel) on the card against the
    CPU. Then the resize kernel against its plain version on odd shapes,
    1 and 224 images, the card's decode on batches with a broken file, the
    trainers' deferred losses read while later work still runs, host rows
    staged to the card while it is busy, and Swin's window-attention
    kernel against its plain path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; the CUDA kernel has no CPU mode")
    ext = tk.build()
    for side, cluster in CLUSTER_OF_SIDE.items():
        assert ext.randaugment_mc_info(side)[0] == cluster, side
        for dtype in (torch.float32, torch.bfloat16):
            for mode in ("plain", "crop", "pad"):
                _forced_ops_match_plain(side, mode, dtype)
    _strided_input_is_read_through_its_strides()
    _side_above_the_limit_raises()
    _resnet_tiny_step_matches_cpu()
    _resnet_tiny_supervised_steps_match_cpu()
    _resize_kernel_matches_plain()
    _broken_file_in_a_batch()
    _deferred_losses_wait_only_for_their_steps()
    _staged_rows_survive_reuse()
    _window_attention_matches_plain()


def _forced_case(side, mode, dtype, seed=0):
    """(x, pi, pf, crop_size, pad): 3 x 14 images. Image i < 14 runs op i in
    slot 1; 14 <= i < 28 runs op i - 14 at v = 9, the sign alternating (the
    geometric shifts are then the largest and cross the blocks' row split);
    i >= 28 runs color, then op i - 28 on its non-integer pixels. Sharpness
    reads every row, so it crosses every block boundary."""
    gen = torch.Generator().manual_seed(seed)
    n = tra.NUM_OPS
    b, pad = 3 * n, side // 8
    pi, pf = tra.sample_randaugment_params(gen, b, side, side)
    ops_ = torch.arange(n)
    pi[:2 * n, 2] = torch.cat([ops_, ops_])
    pi[:2 * n, 3] = 1
    pf[n:2 * n, 0] = 9.0
    pf[n:2 * n, 1] = torch.where(ops_ % 2 == 0, 1.0, -1.0)
    pi[2 * n:, 2:6] = torch.stack(
        [torch.full((n,), tra.OP_COLOR), torch.ones(n, dtype=torch.long),
         ops_, torch.ones(n, dtype=torch.long)], 1).to(torch.int32)
    in_side = side + 2 * pad if mode == "crop" else side
    x = torch.randint(0, 256, (b, in_side, in_side, 3), generator=gen).to(dtype)
    crop = None if mode == "plain" else side
    if crop:
        offs = torch.randint(0, 2 * pad + 1, (b, 2), generator=gen)
        offs[:2] = torch.tensor([[0, 2 * pad], [2 * pad, 0]])
        pi = torch.cat([pi, offs.to(torch.int32)], dim=1)
    return x.cuda(), pi.cuda(), pf.cuda(), crop, pad if mode == "pad" else 0


def _forced_ops_match_plain(side, mode, dtype):
    x, pi, pf, crop, pad = _forced_case(side, mode, dtype)
    before = trace.counter("randaugment/launches")
    got = tk.randaugment_mc(x, pi, pf, crop, pad)
    torch.cuda.synchronize()
    assert trace.counter("randaugment/launches") == before + 1
    assert got.shape == (x.shape[0], side, side, 3) and got.dtype == dtype
    ref = tra.randaugment_mc_plain(x, pi, pf, crop, pad)
    bad = (got != ref).flatten(1).any(1).nonzero().flatten().tolist()
    assert not bad, f"side={side} mode={mode} dtype={dtype}: images {bad}"
    if pad:  # the pad resolved in the load == reflect_pad, then pad = 0
        assert torch.equal(got, tk.randaugment_mc(ops.reflect_pad(x, pad),
                                                  pi, pf, crop))


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
    ch = big.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # planar
    assert torch.equal(tk.randaugment_mc(ch, pi, pf),
                       tk.randaugment_mc(big, pi, pf))
    pi_c = torch.cat([pi, torch.full((4, 2), 3, dtype=torch.int32,
                                     device="cuda")], 1)
    assert torch.equal(tk.randaugment_mc(x, pi_c, pf, 32, pad=4),
                       tk.randaugment_mc(x.contiguous(), pi_c, pf, 32, pad=4))


def _side_above_the_limit_raises():
    side = tk.MAX_SIDE + 1
    x = torch.zeros(1, side, side, 3, device="cuda")
    pi = torch.zeros(1, 6, dtype=torch.int32, device="cuda")
    pf = torch.ones(1, 4, device="cuda")
    with pytest.raises(ValueError, match=str(tk.MAX_SIDE)):
        tk.randaugment_mc(x, pi, pf)
    with pytest.raises(RuntimeError, match=str(tk.MAX_SIDE)):
        tk.build().randaugment_mc(x, pi, pf, side, False)
    assert tk.build().MAX_SIDE == tk.MAX_SIDE


def _resnet_tiny_step_matches_cpu():
    """One FixMatch step of resnet_tiny (32 px, B=4, MU=1, float32 with TF32
    off, THRES 0 so every strong row trains) from the same weights and
    draws, through path C's helpers (``torch_port_checks/path_c.py``): on
    the card, with one kernel launch, and on the CPU. Losses within 1e-4
    relative; the SGD updates within 0.1 relative L2, because at 1x1
    pixels in layer4 a ReLU input within rounding of 0 can take the other
    side on one device and BN spreads it over the batch's gradients
    (tests/torch_port_checks/train.py bounds the CPU's steps alike)."""
    from torch_port_checks import path_c as cs

    cfg = cs.train_config(cs.REAL_3_1,
                          DATA={"IMG_SIZE": 32, "BATCH_SIZE": 4, "MU": 1},
                          MODEL={"NAME": "resnet_tiny"},
                          TRAIN={"DTYPE": "float32", "THRES": 0.0})
    model = cs.seeded_model(cfg, 0, cs.HEAD_STD)
    batch = cs.canonical_batches(cfg, 0, 1)[0]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        ref, ref_upd = cs.step_once(cfg, model, batch, "cpu", 0)
        before = trace.counter("randaugment/launches")
        got, upd = cs.step_once(cfg, model, batch, "cuda", 0)
        assert trace.counter("randaugment/launches") == before + 1
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    assert got[3] == ref[3] == 1.0
    for a, b in zip(got[:3], ref[:3]):
        assert abs(a - b) <= 1e-4 * abs(b), (got, ref)
    l2, _ = cs.update_errors(upd, ref_upd)
    assert l2 <= 0.1, l2


def _resnet_tiny_supervised_steps_match_cpu():
    """One supervised SGD step of resnet_tiny (32 px, B=4, float32 with
    TF32 off), plain and triplet (12 images through ``ModelwEmb``, its
    dropout drawn from the same CPU generator), from the same weights,
    view and draws through path E's helpers
    (``torch_port_checks/path_e.py``), on the card and on the CPU: losses
    and triplet distances within 1e-4
    relative, the SGD updates within 0.1 relative L2 (the FixMatch step's
    bounds, for the same reason)."""
    from torch_port_checks import path_c as cs
    from torch_port_checks import path_e

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for base, triplet in ((path_e.PATHO, False), (path_e.EZBM, True)):
            cfg = path_e.step_config(base, triplet, img=32,
                                     NAME="resnet_tiny")
            model = cs.seeded_model(cfg, 0, cs.HEAD_STD)
            x, t = path_e.step_batch(cfg, 0)
            view = path_e.step_view(cfg, (x, t), 0, "cuda")
            ref, ref_upd = path_e.step_once(cfg, model, view, t, "cpu", 0)
            got, upd = path_e.step_once(cfg, model, view, t, "cuda", 0)
            assert len(got) == len(ref) == (3 if triplet else 1)
            for a, b in zip(got, ref):
                assert abs(a - b) <= 1e-4 * abs(b), (triplet, got, ref)
            l2, _ = cs.update_errors(upd, ref_upd)
            assert l2 <= 0.1, (triplet, l2)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def _resize_kernel_matches_plain():
    """The resize kernel (``data/csrc/jpeg_card.cu``) against its plain
    version, bit for bit, in the decoded batch's padded layout: 161 x 127
    (381-byte rows, no multiple of 16), sides of 1 (zeros), 3 x 7, a 160 →
    224 upscale, 37 x 2000 → 134 (column chunks cut by the source span),
    an output side of 300 (column chunks of 256) and of 134 and 224 (bands
    of 16 and 12 rows, neither dividing the side); one image alone and
    224 images of 160 x 160 (path O2's batch); one launch counted per call.
    A buffer off its 16-byte boundary raises."""
    gen = torch.Generator().manual_seed(3)

    def image(h, w):
        return torch.randint(0, 256, (h, w, 3), generator=gen,
                             dtype=torch.uint8)

    odd = [image(h, w) for h, w in ((161, 127), (1, 9), (9, 1), (3, 7),
                                    (160, 160), (37, 2000), (127, 161))]
    batch = [image(160, 160) for _ in range(224)]
    cases = [([im], size) for im in odd for size in (134, 224)]
    cases += [(odd, size) for size in (1, 134, 224, 300)]
    cases += [(batch, 134), (batch, 112)]
    for images, size in cases:
        flat, offsets, hw = jpeg_card.pack([im.cuda() for im in images])
        before = trace.counter("jpeg/resize_launches")
        got = jpeg_card.resize_bilinear(flat, offsets, hw, size)
        torch.cuda.synchronize()
        assert trace.counter("jpeg/resize_launches") == before + 1
        ref = jpeg_card.resize_bilinear_plain(flat, offsets, hw, size)
        bad = (got != ref).flatten(1).any(1).nonzero().flatten().tolist()
        assert not bad, (size, [tuple(images[i].shape) for i in bad[:4]])
    flat, offsets, hw = jpeg_card.pack([odd[0].cuda()])
    with pytest.raises(RuntimeError, match="16-byte"):
        jpeg_card.resize_bilinear(torch.cat([flat, flat])[1:1 + flat.numel()],
                                  offsets, hw, 134)


def _broken_file_in_a_batch():
    """Batches of 3 and 224 copies of a fixture file, row 1 a broken copy
    (``path_o.broken_jpegs``). 12-bit samples: the batched call fails and
    every payload is decoded again alone, row 1 alone failing; a file cut
    before its scan: left out of the call, which succeeds. The other rows'
    pixels equal a clean batch's, and a clean batch of the same size
    decodes after a failed one."""
    whole = (path_o.FIXTURE / path_o.FIXTURE_FILES[0]).read_bytes()
    for n in (3, 224):
        flat, offsets, hw, status = jpeg_card.decode_raw([whole] * n)
        assert not any(status)
        h, w = hw[0].tolist()
        pitch = jpeg_card.row_pitch(w)

        def image(flat, offsets, i):
            at = int(offsets[i])
            return flat[at:at + h * pitch].view(h, pitch)[:, :3 * w]

        clean = image(flat, offsets, 0)
        for how, redecodes in (("12_bit", n), ("no_scan", 0)):
            payloads = [whole] * n
            payloads[1] = path_o.broken_jpegs(whole)[how]
            before = trace.counter("jpeg/redecodes")
            flat, offsets, hw, status = jpeg_card.decode_raw(payloads)
            assert trace.counter("jpeg/redecodes") - before == redecodes, how
            assert status[1] in jpeg_card.BAD_INPUT, (how, status[1])
            assert not any(status[:1] + status[2:]), how
            assert hw[1].tolist() == [0, 0], how
            for i in (0, n - 1):
                assert torch.equal(image(flat, offsets, i), clean), (how, n, i)
            assert not any(jpeg_card.decode_raw([whole] * n)[3]), (how, n)


def _deferred_losses_wait_only_for_their_steps():
    """Two known losses deferred (``BaseTrainer._defer``), then about half
    a second of device work queued behind them: the drain reads their
    exact values into the meter, in order, while the stream still runs
    that work, so it waited only for the work that made them. Each
    entry's host tensor is pinned."""
    losses = torch.tensor([[0.5, 1.75], [2.25, -3.0]], device="cuda") * 2
    pending, meter = [], AverageMeter()
    for loss in losses:
        BaseTrainer._defer(pending, loss)
    assert all(host.is_pinned() for host, _ in pending)
    torch.cuda._sleep(1_000_000_000)
    before = trace.counter("drain/fetches")
    BaseTrainer._drain_pending(pending, meter, 4, keep=0)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert busy, "the drain waited for the work queued after the losses"
    assert pending == [] and trace.counter("drain/fetches") - before == 2
    assert (meter.sum, meter.count, meter.val) == (12.0, 16, -6.0)


def _staged_rows_survive_reuse():
    """Eight host batches of two shapes staged back to back through
    ``views.rows_on_device`` while about half a second of work keeps the
    card busy, each numpy array overwritten as soon as the call returns,
    and one more from a second thread at the same time, then an eval
    view: the calls return before the card reaches them, every card batch
    holds its original rows, the second thread stages on a copy stream of
    its own, each batch (the view's too) counts once in ``views/staged``,
    and the view equals the CPU's. A card tensor comes back as the same storage,
    uncounted."""
    shapes = ((32, 64, 64, 3), (7, 40, 40, 3))
    for shape in shapes:  # the host allocator's first blocks, made idle
        views.rows_on_device(np.zeros(shape, np.uint8), "cuda")
    views.eval_view(np.zeros(shapes[0], np.uint8), 56, device="cuda")
    torch.cuda.synchronize()
    other = {}

    def second_thread():
        host = np.random.default_rng(1).integers(0, 256, shapes[0],
                                                 dtype=np.uint8)
        other["want"] = host.copy()
        other["got"] = views.rows_on_device(host, "cuda")
        host[...] = 255 - host
        other["stream"] = views._copy_stream(torch.device("cuda"))

    rng = np.random.default_rng(0)
    wanted, staged = [], []
    before = trace.counter("views/staged")
    torch.cuda._sleep(1_000_000_000)
    thread = threading.Thread(target=second_thread)
    thread.start()
    for i in range(8):
        host = rng.integers(0, 256, shapes[i % 2], dtype=np.uint8)
        wanted.append(host.copy())
        staged.append(views.rows_on_device(host, "cuda"))
        host[...] = 255 - host  # the caller reuses its array at once
    host = rng.integers(0, 256, shapes[0], dtype=np.uint8)
    view = views.eval_view(host, 56, device="cuda")
    thread.join(timeout=60)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert busy, "staging waited for the work queued before it"
    torch.testing.assert_close(view.cpu(),
                               views.eval_view(host, 56, device="cpu"))
    assert not thread.is_alive() and len(other) == 3
    for want, got in zip(wanted + [other["want"]], staged + [other["got"]]):
        assert torch.equal(got.cpu(), torch.from_numpy(want))
    assert other["stream"] != views._copy_stream(torch.device("cuda"))
    assert trace.counter("views/staged") - before == 10
    card = staged[0]
    back = views.rows_on_device(card, "cuda")
    assert (back.untyped_storage().data_ptr()
            == card.untyped_storage().data_ptr())
    assert trace.counter("views/staged") - before == 10


def _window_attention_matches_plain():
    """Each Swin-T stage's blocks at ``path_l.WA_IMAGES`` images (shifted
    and unshifted; stage 4's one window): the output, d(qkv) and the bias
    gradient against the plain path within ``path_l``'s limits; a strided
    ``qkv`` view; the counter; the float32 input's plain path; the shapes
    the kernel refuses."""
    from endoscopy_tpu_torch.ops import window_attention as wa

    for side, heads, _ in path_l.SWIN_T_STAGES:
        for shifted in (False, True)[:1 + (side > path_l.WINDOW)]:
            case = path_l.window_attention_case(side, heads, shifted,
                                                path_l.WA_IMAGES, side)
            before = trace.counter("window_attention/fused")
            err = path_l.window_attention_errors(*case)
            assert trace.counter("window_attention/fused") == before + 2
            assert not path_l.window_attention_faults(err), (side, shifted,
                                                             err)

    # qkv read through its strides: the windows of a larger batch, rows
    # apart; the kernel is deterministic, so the same bits
    qkv, bias, mask, dout = path_l.window_attention_case(28, 6, True, 4, 1)
    big = torch.zeros((2 * qkv.shape[0],) + qkv.shape[1:], dtype=qkv.dtype,
                      device=qkv.device)
    big[1::2] = qkv
    strided = big[1::2]
    assert not strided.is_contiguous()
    got = path_l.window_attention_grads(wa.window_attention, strided, bias,
                                        mask, dout)
    want = path_l.window_attention_grads(wa.window_attention, qkv, bias,
                                         mask, dout)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with torch.no_grad():  # no autograd record: the same output
        assert torch.equal(wa.window_attention(qkv, bias, mask), want[0])

    before = trace.counter("window_attention/fused")
    out32 = wa.window_attention(qkv.float(), bias, mask)
    assert out32.dtype == torch.float32
    assert trace.counter("window_attention/fused") == before
    for bad, args in (
            ("over the kernel's tile",
             (torch.zeros(4, 81, 3, 3, 32), torch.zeros(3, 81, 81), None)),
            ("head width", (torch.zeros(4, 49, 3, 3, 16), bias.cpu(), None))):
        args = tuple(None if a is None else a.cuda() for a in args)
        with pytest.raises(ValueError, match=bad):
            wa.window_attention(args[0].bfloat16(), *args[1:])

