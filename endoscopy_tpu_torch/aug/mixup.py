"""Mixup / CutMix on the device (port of ``endoscopy_tpu/aug/mixup.py``).

timm ``Mixup`` semantics in batch mode, against the flipped batch
``x.flip(0)``:

- with probability ``prob`` the batch is mixed, else it passes through;
- with both alphas active, CutMix is chosen with probability
  ``switch_prob`` (CutMix alone when ``mixup_alpha`` is 0);
- mixup: ``lam ~ Beta(a, a)``, ``x = lam x + (1 - lam) flip(x)``;
- CutMix: a box of relative area about ``1 - lam`` (``_rand_bbox``: side
  ``int32(sqrt(1 - lam) · h)``, centre uniform, clipped to the image) takes
  the flipped batch's pixels, and ``lam`` becomes the box's real share;
- targets: ``lam onehot(y) + (1 - lam) onehot(flip(y))`` with label
  smoothing ``on = 1 - eps + eps / C``, ``off = eps / C``.

Every draw (apply, switch, the two Betas and the box centre) enters in
``draws`` or comes from the caller's ``torch.Generator``
(:func:`sample_mixup_draws`); the branches are selected on the device, so
a step makes no host round trip. The supervised trainer mixes each
microbatch with its own flip, as the JAX step mixes inside its per-micro
loss, so under ``TRAIN.GRAD_ACCUM`` an image is paired within its
microbatch.

In a process group the flipped batch is the global batch's: rank ``r``'s
partner rows are rank ``P - 1 - r``'s, reversed, exchanged with it
(``parallel/sharding.py::flip_rows``); every rank draws the same ``lam``
and box from its generator, which the ranks seed alike.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from endoscopy_tpu_torch.parallel.sharding import flip_rows


def _gamma(alpha: float, generator: torch.Generator, candidates: int = 16
           ) -> torch.Tensor:
    """One Gamma(alpha) draw on the generator's device, by Marsaglia and
    Tsang's method: ``candidates`` proposals at once and the first accepted
    one. A proposal is accepted with probability at least 0.95 (the shape
    is raised by 1 below 1 and the draw scaled by ``U^(1/alpha)``), so all
    16 fail with probability under 1e-20; then the first is taken."""
    dev = generator.device
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = (9.0 * d) ** -0.5
    z = torch.randn(candidates, generator=generator, device=dev)
    u = torch.rand(candidates, generator=generator, device=dev)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v
                    + d * torch.log(v.clamp_min(1e-30)))
    sample = d * v[torch.argmax(ok.int())]
    if alpha < 1.0:
        sample = sample * torch.rand((), generator=generator,
                                     device=dev) ** (1.0 / alpha)
    return sample


def _beta(alpha: float, generator: torch.Generator) -> torch.Tensor:
    g1, g2 = _gamma(alpha, generator), _gamma(alpha, generator)
    return g1 / (g1 + g2)


def sample_mixup_draws(generator: torch.Generator, h: int, w: int,
                       mixup_alpha: float, cutmix_alpha: float
                       ) -> Dict[str, torch.Tensor]:
    """The draws of one :func:`mixup_cutmix` call: ``apply`` and ``switch``
    U(0, 1), ``lam_m`` Beta(mixup_alpha) and ``lam_c`` Beta(cutmix_alpha)
    (1 when that alpha is 0), and the box centre ``cy``, ``cx``."""
    dev = generator.device
    one = torch.ones((), device=dev)
    return {
        "apply": torch.rand((), generator=generator, device=dev),
        "switch": torch.rand((), generator=generator, device=dev),
        "lam_m": _beta(mixup_alpha, generator) if mixup_alpha > 0 else one,
        "lam_c": _beta(cutmix_alpha, generator) if cutmix_alpha > 0 else one,
        "cy": torch.randint(0, h, (), generator=generator, device=dev),
        "cx": torch.randint(0, w, (), generator=generator, device=dev),
    }


def smooth_one_hot(targets: torch.Tensor, num_classes: int,
                   smoothing: float) -> torch.Tensor:
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(targets.long(), num_classes).float() * (on - off) + off


def _rand_bbox(h: int, w: int, lam: torch.Tensor, cy: torch.Tensor,
               cx: torch.Tensor):
    """CutMix box of relative area about ``1 - lam``: ``(y0, x0, y1, x1)``."""
    ratio = torch.sqrt(1.0 - lam)
    cut_h = (ratio * h).to(torch.int32)
    cut_w = (ratio * w).to(torch.int32)
    y0 = torch.clamp(cy - cut_h // 2, 0, h)
    x0 = torch.clamp(cx - cut_w // 2, 0, w)
    y1 = torch.clamp(cy + cut_h // 2, 0, h)
    x1 = torch.clamp(cx + cut_w // 2, 0, w)
    return y0, x0, y1, x1


def mixup_cutmix(x: torch.Tensor, targets: torch.Tensor, num_classes: int,
                 mixup_alpha: float = 0.0, cutmix_alpha: float = 0.0,
                 prob: float = 1.0, switch_prob: float = 0.5,
                 label_smoothing: float = 0.1,
                 generator: Optional[torch.Generator] = None, *,
                 draws: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-mode mix of an NHWC batch; returns ``(mixed x, soft targets
    (B, C))``. ``draws`` (see :func:`sample_mixup_draws`) overrides the
    generator."""
    b, h, w, _ = x.shape
    if draws is None:
        if generator is None:
            raise ValueError("pass a torch.Generator or the draws")
        draws = sample_mixup_draws(generator, h, w, mixup_alpha, cutmix_alpha)
    d = {k: torch.as_tensor(v, device=x.device) for k, v in draws.items()}
    y1 = smooth_one_hot(targets.to(x.device), num_classes, label_smoothing)
    y2 = flip_rows(y1)
    x2 = flip_rows(x)

    use_mix = d["apply"] < prob
    use_cutmix = torch.as_tensor(
        cutmix_alpha > 0, device=x.device) & (
        torch.as_tensor(mixup_alpha <= 0, device=x.device)
        | (d["switch"] < switch_prob))
    lam_m = d["lam_m"].float() if mixup_alpha > 0 else torch.ones(
        (), device=x.device)
    lam_c = d["lam_c"].float() if cutmix_alpha > 0 else torch.ones(
        (), device=x.device)

    x_mix = lam_m.to(x.dtype) * x + (1 - lam_m).to(x.dtype) * x2
    y0, x0, yb1, xb1 = _rand_bbox(h, w, lam_c, d["cy"], d["cx"])
    yg = torch.arange(h, device=x.device)[:, None]
    xg = torch.arange(w, device=x.device)[None, :]
    box = (yg >= y0) & (yg < yb1) & (xg >= x0) & (xg < xb1)
    x_cut = torch.where(box[None, :, :, None], x2, x)
    lam_c_real = 1.0 - ((yb1 - y0) * (xb1 - x0)).float() / (h * w)

    mixed_x = torch.where(use_cutmix, x_cut, x_mix)
    lam = torch.where(use_cutmix, lam_c_real, lam_m)
    mixed_y = lam * y1 + (1 - lam) * y2
    return (torch.where(use_mix, mixed_x, x),
            torch.where(use_mix, mixed_y, y1))
