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
from endoscopy_tpu_torch.aug import randaugment as tra
from endoscopy_tpu_torch.ops import randaugment_kernel as tk

S = 24
SHARPNESS_ATOL = 0.51  # the JAX package's own bar (test_pallas_kernel.py)


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
    before = tk.randaugment_mc.launches
    out = tk.randaugment_mc(x, pi, pf)
    assert tk.randaugment_mc.launches == before
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
