"""Port checks: eval and FixMatch views against the JAX package's views.

The JAX ``fixmatch_views`` is run through its Pallas (crop-fused) path with
the kernel in interpret mode, and its random draws (flips, crop offsets,
``(pi, pf)``) are re-derived from the same key and fed to the port. In
float32 the pixels are identical. In bf16 the JAX CPU backend keeps float32
precision between the normalize ops where PyTorch rounds each op to bf16,
so the normalized outputs may differ by one bf16 step (2**-7 relative).
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from endoscopy_tpu.aug import ops as jops
from endoscopy_tpu.aug import views as jviews
from endoscopy_tpu.ops import randaugment_kernel as rk
from endoscopy_tpu_torch.aug import views

IMG = 24
CANON = int(IMG * 1.2)
B = 4


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (B, CANON, CANON, 3)).astype(np.uint8)


def check_eval_view_matches_jax():
    for dtype in ("float32", "bfloat16"):
        _eval_view_matches_jax(dtype)


def _eval_view_matches_jax(dtype):
    u8 = _batch()
    ref = jviews.eval_view(jnp.asarray(u8), IMG, getattr(jnp, dtype))
    got = views.eval_view(u8, IMG, getattr(torch, dtype), device="cpu")
    assert got.shape == (B, IMG, IMG, 3) and got.dtype == getattr(torch, dtype)
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=2 ** -7)


def _jax_draws(key, n):
    """The flips, crop offsets and (pi, pf) that jax fixmatch_views draws
    from ``key`` on its Pallas path (aug/views.py:121-141)."""
    k_pre, k_ra = jax.random.split(key)
    padding = int(IMG * 0.125)
    flips, tops, lefts = [], [], []
    for k in jax.random.split(k_pre, n):
        k_flip, k_crop = jax.random.split(k)
        flips.append(bool(jax.random.uniform(k_flip) < 0.5))
        t, l = jops.sample_crop_offsets(k_crop, 2 * padding)
        tops.append(int(t))
        lefts.append(int(l))
    pi, pf = rk.sample_randaugment_params(k_ra, n, IMG, IMG)
    return (np.asarray(flips), np.asarray(tops, np.int32),
            np.asarray(lefts, np.int32), np.array(pi), np.array(pf))


def _jax_pallas_views(u8, key, dtype):
    """jax fixmatch_views forced onto its Pallas path, interpret mode."""
    orig = rk.randaugment_mc_pallas
    with mock.patch.object(jviews, "USE_PALLAS_RANDAUG", True), \
            mock.patch.object(rk, "randaugment_mc_pallas",
                              lambda *a, **k: orig(*a, interpret=True, **k)):
        return jviews.fixmatch_views(jnp.asarray(u8), key, IMG, dtype)


def check_fixmatch_views_match_jax():
    for dtype in ("float32", "bfloat16"):
        _fixmatch_views_match_jax(dtype)


def _fixmatch_views_match_jax(dtype):
    u8 = _batch(1)
    key = jax.random.key(5)
    weak_j, strong_j = _jax_pallas_views(u8, key, getattr(jnp, dtype))
    flips, tops, lefts, pi, pf = _jax_draws(key, B)
    assert flips.any() and not flips.all()  # both branches exercised
    weak, strong = views.fixmatch_views(
        u8, IMG, getattr(torch, dtype), device="cpu", flips=flips,
        tops=tops, lefts=lefts, pi=pi, pf=pf)
    for got, ref in ((weak, weak_j), (strong, strong_j)):
        assert got.shape == (B, IMG, IMG, 3)
        assert got.dtype == getattr(torch, dtype)
        ref = np.asarray(ref.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_array_equal(got.numpy(), ref)
        else:
            np.testing.assert_allclose(got.float().numpy(), ref,
                                       rtol=2 ** -7, atol=2 ** -7)


def check_fixmatch_views_from_generator_are_seeded():
    u8 = _batch(2)
    outs = [views.fixmatch_views(u8, IMG, torch.float32,
                                 torch.Generator().manual_seed(9),
                                 device="cpu") for _ in range(2)]
    other = views.fixmatch_views(u8, IMG, torch.float32,
                                 torch.Generator().manual_seed(10),
                                 device="cpu")
    assert torch.equal(outs[0][1], outs[1][1])
    assert not torch.equal(outs[0][1], other[1])
    assert torch.equal(outs[0][0], other[0])  # weak view is deterministic
    with pytest.raises(ValueError, match="Generator"):
        views.fixmatch_views(u8, IMG, device="cpu")
    with pytest.raises(ValueError, match="tops with lefts"):
        views.fixmatch_views(u8, IMG, generator=torch.Generator(),
                             device="cpu", tops=np.zeros(B, np.int32))
