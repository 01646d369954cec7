"""Port checks: the plain RandAugment and the kernel wrapper against the Pallas kernel.

The JAX reference is the Pallas kernel run as the JAX package's own tests
run it on the CPU (interpret mode), fed the same ``(pi, pf)``. The port's
plain version must give the same pixels exactly; the bar the JAX package
holds its own kernel to is exact except sharpness (0.51, summation order),
and the port is held to the same. On the CPU the wrapper takes the plain
version; the CUDA kernel itself is compared with it on the card by
``tests/test_torch_port_kernel_cuda.py`` and by ``chip_smoke.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from endoscopy_tpu.ops import randaugment_kernel as rk
from endoscopy_tpu_torch.aug import ops as tops_
from endoscopy_tpu_torch.aug import randaugment as tra
from endoscopy_tpu_torch.ops import randaugment_kernel as tk
from endoscopy_tpu_torch.utils import trace

S = 24
SHARPNESS_ATOL = 0.51  # the JAX package's own bar (test_pallas_kernel.py)
ULP_255 = float(np.spacing(np.float32(255.0)))  # a float32 ulp at 255


def _pallas_forced(imgs, pi, pf):
    """The Pallas ``_kernel`` in interpret mode with given (pi, pf) (as
    tests/test_pallas_kernel.py::_forced_kernel), in the input dtype."""
    b, h, w, _ = imgs.shape
    planar = jnp.asarray(imgs).transpose(0, 3, 1, 2)
    spec = pl.BlockSpec((1, 3, h, w), lambda i, *_: (i, 0, 0, 0),
                        memory_space=pltpu.VMEM)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(b,), in_specs=[spec], out_specs=spec,
        scratch_shapes=[pltpu.VMEM((3, h, w), jnp.float32)])
    out = pl.pallas_call(
        functools.partial(rk._kernel, n_slots=pf.shape[1] // 2, h=h, w=w,
                          PAD=rk._pad_for(h)),
        out_shape=jax.ShapeDtypeStruct(planar.shape, planar.dtype),
        grid_spec=grid_spec, interpret=True,
    )(jnp.asarray(pi), jnp.asarray(pf), planar)
    return np.asarray(out.transpose(0, 2, 3, 1).astype(jnp.float32))


def _plain(imgs, pi, pf, crop_size=None):
    out = tk.randaugment_mc(torch.from_numpy(np.array(imgs)),
                            torch.from_numpy(np.array(pi)),
                            torch.from_numpy(np.array(pf)),
                            crop_size=crop_size)
    return out.float().numpy()


def _assert_match(got, ref, pi):
    """Exact, except images that ran sharpness: <= SHARPNESS_ATOL."""
    n = (pi.shape[1] - 2) // 2
    ops_run = [{int(pi[i, 2 + 2 * s]) for s in range(n) if pi[i, 3 + 2 * s]}
               for i in range(pi.shape[0])]
    for i, ops in enumerate(ops_run):
        atol = SHARPNESS_ATOL if tra.OP_SHARPNESS in ops else 0.0
        np.testing.assert_allclose(got[i], ref[i], rtol=0, atol=atol,
                                   err_msg=f"image {i}, ops {ops}")


# Every op forced into slot 1 (apply=1) of two images, with a random slot
# 2; and every op forced into slot 2 of a third image whose slot 1 is
# color, so that the op also sees non-integer pixels. One interpret call
# serves all 14 cases.
@functools.cache
def forced_case():
    rng = np.random.default_rng(1)
    n = tra.NUM_OPS
    b = 3 * n
    imgs = rng.integers(0, 256, (b, S, S, 3)).astype(np.float32)
    pi = np.zeros((b, 6), np.int32)
    pi[:, 0] = rng.integers(0, S, b)
    pi[:, 1] = rng.integers(0, S, b)
    pi[:, 3] = 1
    pi[:2 * n, 2] = np.repeat(np.arange(n), 2)
    pi[:2 * n, 4] = rng.integers(0, n, 2 * n)
    pi[:2 * n, 5] = rng.integers(0, 2, 2 * n)
    pi[2 * n:, 2] = tra.OP_COLOR
    pi[2 * n:, 4] = np.arange(n)
    pi[2 * n:, 5] = 1
    pf = np.stack([rng.integers(1, 10, b), rng.choice([-1.0, 1.0], b),
                   rng.integers(1, 10, b), rng.choice([-1.0, 1.0], b)],
                  axis=1).astype(np.float32)
    pf[0:2 * n:2, 0] = 9  # the largest magnitude, both signs, for every op
    return imgs, pi, pf, _pallas_forced(imgs, pi, pf)


def check_forced_ops_match_pallas():
    imgs, pi, pf, ref = forced_case()
    for op in range(tra.NUM_OPS):
        sel = [2 * op, 2 * op + 1, 2 * tra.NUM_OPS + op]
        got = _plain(imgs[sel], pi[sel], pf[sel])
        _assert_match(got, ref[sel], pi[sel])


def check_sampled_params_match_pallas():
    """Random (pi, pf) from the JAX sampler through both versions."""
    for seed in (3, 11):
        rng = np.random.default_rng(seed)
        imgs = jnp.asarray(rng.integers(0, 256, (8, S, S, 3)), jnp.float32)
        key = jax.random.key(seed)
        ref = np.asarray(rk.randaugment_mc_pallas(imgs, key, interpret=True))
        pi, pf = map(np.asarray, rk.sample_randaugment_params(key, 8, S, S))
        _assert_match(_plain(imgs, pi, pf), ref, pi)


def check_crop_fused_matches_pallas():
    """Crop-fused mode (padded input + per-sample offsets), in f32 and in
    bf16 I/O, against the Pallas crop-fused launch."""
    for dtype in (jnp.float32, jnp.bfloat16):
        _crop_fused_matches_pallas(dtype)


def _crop_fused_matches_pallas(dtype):
    padding = 3
    rng = np.random.default_rng(7)
    p = S + 2 * padding
    imgs = jnp.asarray(rng.integers(0, 256, (6, p, p, 3)), dtype)
    tops = rng.integers(0, 2 * padding + 1, 6).astype(np.int32)
    lefts = rng.integers(0, 2 * padding + 1, 6).astype(np.int32)
    key = jax.random.key(7)
    ref = np.asarray(rk.randaugment_mc_pallas(
        imgs, key, interpret=True, crop_offsets=(jnp.asarray(tops),
                                                 jnp.asarray(lefts)),
        crop_size=S).astype(jnp.float32))
    pi, pf = map(np.array, rk.sample_randaugment_params(key, 6, S, S))
    pi = np.concatenate([pi, tops[:, None], lefts[:, None]], axis=1)
    got = tk.randaugment_mc(
        torch.from_numpy(np.array(imgs.astype(jnp.float32))).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32),
        torch.from_numpy(pi), torch.from_numpy(pf), crop_size=S)
    assert got.dtype == (torch.bfloat16 if dtype == jnp.bfloat16
                         else torch.float32)
    assert got.shape == (6, S, S, 3)
    _assert_match(got.float().numpy(), ref, pi)


def check_bf16_io_matches_pallas():
    """bf16 block I/O: bf16 in, f32 compute, bf16 out — the same pixels as
    the Pallas kernel's bf16 launch."""
    imgs, pi, pf, _ = forced_case()
    imgs16 = jnp.asarray(imgs, jnp.bfloat16)
    ref = _pallas_forced(imgs16, pi, pf)
    got = tk.randaugment_mc(torch.from_numpy(imgs).to(torch.bfloat16),
                            torch.from_numpy(pi), torch.from_numpy(pf))
    assert got.dtype == torch.bfloat16
    _assert_match(got.float().numpy(), ref, pi)


def check_cpu_wrapper_takes_plain_version_and_launches_nothing():
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (3, S, S, 3), generator=gen).float()
    pi, pf = tra.sample_randaugment_params(gen, 3, S, S)
    before = trace.counter("randaugment/launches")
    out = tk.randaugment_mc(x, pi, pf)
    assert trace.counter("randaugment/launches") == before
    assert torch.equal(out, tra.randaugment_mc_plain(x, pi, pf))


def check_wrapper_rejects_bad_input():
    for bad in ("pi_dtype", "pf_shape", "channels", "crop_cols", "uint8"):
        _wrapper_rejects(bad)


def _wrapper_rejects(bad):
    x = torch.zeros(2, S, S, 3)
    pi = torch.zeros(2, 6, dtype=torch.int32)
    pf = torch.ones(2, 4)
    crop = None
    if bad == "pi_dtype":
        pi = pi.long()
    elif bad == "pf_shape":
        pf = torch.ones(2, 3)
    elif bad == "channels":
        x = torch.zeros(2, S, S, 4)
    elif bad == "crop_cols":
        crop = S - 4  # crop mode needs the two offset columns
    elif bad == "uint8":
        x = x.to(torch.uint8)
    with pytest.raises(ValueError):
        tk.randaugment_mc(x, pi, pf, crop_size=crop)


def _pad_fused_case(side, pad, seed):
    """Images of ``side`` px, offsets in the frame padded by ``pad`` (both
    extremes included), and the Pallas crop-fused launch on the
    ``jnp.pad(mode="reflect")`` batch (one interpret call)."""
    rng = np.random.default_rng(seed)
    b = 8
    imgs = rng.integers(0, 256, (b, side, side, 3)).astype(np.float32)
    offs = rng.integers(0, 2 * pad + 1, (b, 2)).astype(np.int32)
    offs[:2] = [[0, 2 * pad], [2 * pad, 0]]
    key = jax.random.key(seed)
    padded = jnp.pad(jnp.asarray(imgs), ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                     mode="reflect")
    ref = np.asarray(rk.randaugment_mc_pallas(
        padded, key, interpret=True,
        crop_offsets=(jnp.asarray(offs[:, 0]), jnp.asarray(offs[:, 1])),
        crop_size=side))
    pi, pf = map(np.array, rk.sample_randaugment_params(key, b, side, side))
    pi = np.concatenate([pi, offs], axis=1)
    return imgs, pi, pf, ref


def check_pad_fused_matches_reflect_pad_and_pallas():
    """``pad > 0``: the plain version (the CPU wrapper) equals itself on
    ``reflect_pad(x, pad)`` with ``pad = 0`` exactly, and the Pallas kernel
    on the ``jnp.pad`` batch (exact but sharpness); in f32 and bf16 I/O, at
    an even and an odd side. The bf16 reference is the f32 one rounded to
    bf16, which the Pallas bf16 launch gives for integer pixels (its
    docstring)."""
    for side, pad, seed in ((32, 4, 21), (37, 4, 22)):
        imgs, pi, pf, ref = _pad_fused_case(side, pad, seed)
        pi_t, pf_t = torch.from_numpy(pi), torch.from_numpy(pf)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(imgs).to(dtype)
            got = tk.randaugment_mc(x, pi_t, pf_t, crop_size=side, pad=pad)
            assert got.dtype == dtype and got.shape == (8, side, side, 3)
            unfused = tk.randaugment_mc(tops_.reflect_pad(x, pad), pi_t, pf_t,
                                        crop_size=side)
            assert torch.equal(got, unfused), (side, dtype)
            want = torch.from_numpy(np.array(ref)).to(dtype).float().numpy()
            _assert_match(got.float().numpy(), want, pi)


def check_wrapper_rejects_bad_pad():
    """``pad`` needs ``crop_size`` and ``0 <= pad < S``; the window fits in
    ``S + 2 pad``; no output side above the kernel's limit."""
    x = torch.zeros(2, S, S, 3)
    pi = torch.zeros(2, 8, dtype=torch.int32)
    pf = torch.ones(2, 4)
    for crop, pad, match in ((None, 2, "crop_size"), (S, S, "pad"),
                             (S, -1, "pad"), (S + 9, 4, "crop_size")):
        with pytest.raises(ValueError, match=match):
            tk.randaugment_mc(x, pi if crop else pi[:, :6], pf,
                              crop_size=crop, pad=pad)
    big = tk.MAX_SIDE + 1
    with pytest.raises(ValueError, match=str(tk.MAX_SIDE)):
        tk.randaugment_mc(torch.zeros(1, big, big, 3), pi[:1, :6], pf[:1])
    out = tk.randaugment_mc(x, pi, pf, crop_size=S + 8, pad=4)  # S + 2 pad fits
    assert out.shape == (2, S + 8, S + 8, 3)


def check_param_sampling_distribution():
    """The torch sampler's (pi, pf) has the Pallas sampler's layout and
    distribution (as tests/test_pallas_kernel.py checks the JAX one)."""
    gen = torch.Generator().manual_seed(0)
    pi, pf = tra.sample_randaugment_params(gen, 4096, S, S)
    assert pi.dtype == torch.int32 and pi.shape == (4096, 6)
    assert pf.dtype == torch.float32 and pf.shape == (4096, 4)
    pi, pf = pi.numpy(), pf.numpy()
    ops, applies = pi[:, 2::2].ravel(), pi[:, 3::2].ravel()
    assert ops.min() >= 0 and ops.max() <= 13
    assert set(np.unique(ops)) == set(range(14))
    assert 0.45 < applies.mean() < 0.55
    assert set(np.unique(applies)) == {0, 1}
    v = pf[:, 0::2].ravel()
    assert v.min() >= 1 and v.max() <= 9 and set(np.unique(v)) == set(range(1, 10))
    assert set(np.unique(pf[:, 1::2])) == {-1.0, 1.0}
    assert 0.45 < (pf[:, 1::2] > 0).mean() < 0.55
    assert pi[:, :2].min() >= 0 and pi[:, :2].max() <= S - 1


def _jax_pc_draws(key, h, w, n, m):
    """The slot draws JAX ``randaugment_pc(img, key, n, m)`` makes
    (aug/randaugment.py:272-285): each slot's op, sign and apply, the
    centre its Cutout op would take, and the final CutoutAbs's centre."""
    from endoscopy_tpu.aug import randaugment as jra

    def centre(k):
        kx, ky = jax.random.split(k)
        return [float(jax.random.uniform(kx, (), minval=0.0, maxval=w)),
                float(jax.random.uniform(ky, (), minval=0.0, maxval=h))]

    op_ids, signs, applies, slot_cuts = [], [], [], []
    for _ in range(n):
        key, k_slot, k_branch = jax.random.split(key, 3)
        op, _, sign, apply = jra.sample_pc_slot_params(k_slot, m)
        op_ids.append(int(op))
        signs.append(float(sign))
        applies.append(bool(apply))
        slot_cuts.append(centre(k_branch))
    _, k_cut = jax.random.split(key)
    return op_ids, signs, applies, slot_cuts, centre(k_cut)


def check_randaugment_pc_matches_jax():
    """The plain RandAugmentPC (no trainer calls it; no kernel) against JAX
    ``randaugment_pc`` on the same slot draws, at m 10 (the reference's)
    and 7 (posterize and solarize at other than their extremes), 48
    images a magnitude so that every one of the 16 ops is applied: within
    one float32 ulp at 255 (1.5e-5; JAX's ``ops.color`` groups the
    luminance's fused multiply-adds otherwise than the kernel's order the
    port follows, and its grey differs by that ulp: measured 1.5e-5),
    except images that ran sharpness (0.51: the JAX package's bar; JAX
    computes its blur as a convolution) or contrast (1.0: a contrast mean
    that rounds the other way at a near-tie moves a pixel by at most
    factor - 1 < 1), as the RandAugmentMC checks and ``chip_smoke.py``
    hold them."""
    from endoscopy_tpu.aug import randaugment as jra

    b, n = 48, 2
    seen = set()
    for m in (10, 7):
        rng = np.random.default_rng(m)
        imgs = rng.integers(0, 256, (b, S, S, 3)).astype(np.float32)
        keys = jax.random.split(jax.random.key(100 + m), b)
        want = np.asarray(jax.jit(jax.vmap(
            lambda im, k, m=m: jra.randaugment_pc(im, k, n=n, m=m)))(
            jnp.asarray(imgs), keys))
        draws = [_jax_pc_draws(k, S, S, n, m) for k in keys]
        op_ids, signs, applies, slot_cuts, cuts = (
            torch.tensor([d[i] for d in draws]) for i in range(5))
        got = tra.randaugment_pc(torch.from_numpy(imgs), op_ids, signs,
                                 applies, slot_cuts, cuts, m=m).numpy()
        for i in range(b):
            ran = {o for o, a in zip(draws[i][0], draws[i][2]) if a}
            seen |= ran
            if ran & {tra.PC_SHARPNESS, tra.PC_CONTRAST}:
                atol = (SHARPNESS_ATOL if tra.PC_SHARPNESS in ran else 1.0)
                np.testing.assert_allclose(got[i], want[i], rtol=0,
                                           atol=atol, err_msg=f"m {m}, "
                                           f"image {i}, ops {ran}")
                continue
            np.testing.assert_allclose(got[i], want[i], rtol=0, atol=ULP_255,
                                       err_msg=f"m {m}, image {i}, ops {ran}")
    assert seen == set(range(tra.PC_NUM_OPS)), seen
    d = tra.pc_draws(torch.Generator().manual_seed(0), 4000, S, S)
    assert set(d["op_ids"].unique().tolist()) == set(range(tra.PC_NUM_OPS))
    assert 0.45 < float(d["applies"].float().mean()) < 0.55
    assert 0.0 <= float(d["cuts"].min()) and float(d["cuts"].max()) < S
