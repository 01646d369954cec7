"""Visualization helpers (port of ``endoscopy_tpu/eval/visualize.py``;
reference utils.py:59-117, 157-173).

matplotlib is optional: without it every function returns its arrays and
writes no PNG (the card's machine promises no matplotlib). The plotting
helpers are host numpy, as in the JAX package. :func:`preview_views`
renders the trainer's own views with ``aug/views.py`` on the run's device,
so on the card a FixMatch preview launches the RandAugment kernel once
(crop-fused) and a CoMatch preview once in plain mode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from endoscopy_tpu_torch.aug import views as V
from endoscopy_tpu_torch.device import resolve_device
from endoscopy_tpu_torch.eval.metrics import confusion_matrix
from endoscopy_tpu_torch.utils.plotting import _plt

# the ImageNet statistics as float32 arrays, as the JAX package keeps them
IMAGENET_MEAN = np.array(V.IMAGENET_MEAN, dtype=np.float32)
IMAGENET_STD = np.array(V.IMAGENET_STD, dtype=np.float32)


def denormalize(img: np.ndarray, mean=None, std=None) -> np.ndarray:
    """Undo normalization for display (utils.py:70-81). Defaults to the
    ImageNet statistics; reproduce-mode images pass mean=std=0.5."""
    mean = IMAGENET_MEAN if mean is None else mean
    std = IMAGENET_STD if std is None else std
    out = np.asarray(img) * np.asarray(std) + np.asarray(mean)
    return np.clip(out, 0.0, 1.0)


def show_cfs_matrix(targets, preds, num_classes: int, percent: bool = False,
                    save_path: Optional[str] = None) -> np.ndarray:
    """Confusion-matrix heatmap (utils.py:59-68); returns the matrix."""
    cm = confusion_matrix(targets, preds, num_classes)
    data = cm.astype(float)
    if percent:
        col = data.sum(axis=0, keepdims=True)
        data = data / np.maximum(col, 1.0)
    plt = _plt()
    if plt is not None:
        fig, ax = plt.subplots(figsize=(8, 8))
        im = ax.imshow(data, cmap="Blues")
        for i in range(num_classes):
            for j in range(num_classes):
                ax.text(j, i, f"{data[i, j]:.2f}" if percent else f"{int(data[i, j])}",
                        ha="center", va="center", fontsize=8)
        ax.set_ylabel("Actual")
        ax.set_xlabel("Predicted")
        fig.colorbar(im)
        if save_path:
            fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return cm


def show_grid(images: Sequence[np.ndarray], save_path: Optional[str] = None,
              mean=None, std=None):
    """Row of de-normalized images (utils.py:98-117)."""
    imgs = [denormalize(im, mean, std) for im in images]
    plt = _plt()
    if plt is not None:
        fig, axes = plt.subplots(1, len(imgs), figsize=(4 * len(imgs), 4))
        if len(imgs) == 1:
            axes = [axes]
        for ax, im in zip(axes, imgs):
            ax.imshow(im)
            ax.axis("off")
        if save_path:
            fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return imgs


def _first_rows(dl, n: int):
    """The first ``n`` rows of a loader and their targets. The
    random-access ``sample()`` protocol keeps a preview from using up a
    permutation draw of the loader's seeded stream (a seeded run with
    ``--preview`` trains on the batches of the same run without it);
    iteration is the fallback for loaders without it."""
    if hasattr(dl, "sample") and hasattr(dl, "manifest"):
        t = np.asarray(dl.manifest.targets)
        idx = np.arange(min(n, len(t)))
        return dl.sample(idx), t[idx]
    batch_u8, targets = next(iter(dl))
    return batch_u8[:n], np.asarray(targets)[:n]


def preview_views(config, train_dl, save_path: Optional[str] = None,
                  seed: int = 0, device=None):
    """One-batch augmentation preview at data-build time (reference
    dataset.py:361-368, 389-397, 427-441; learn.py:51 enables it on every
    run): the exact view functions the trainer uses, on ``device``, with
    their draws from ``torch.Generator(device).manual_seed(seed)`` (the
    labeled view's first, then the unlabeled views').

    SSL: renders [labeled-train, weak, strong] (FixMatch/SemiFormer) or
    [labeled-train, weak, strong0, strong1] (CoMatch) for the first sample.
    Supervised: the first 4 train-view samples, or [anchor, positive,
    negative] when MODEL.IS_TRIPLET (dataset.py:434-437; the positive and
    negative drawn with ``np.random.default_rng(seed)``). Returns the
    de-normalized float32 image list (the show_grid contract).
    """
    dev = resolve_device(device)
    size = int(config.DATA.IMG_SIZE)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    reprod = bool(config.DATA.get("IS_REPROD", False))
    # the preview must render the EXACT view the trainer will use
    train_view = V.reproduce_train_view if reprod else V.labeled_train_view

    def view(u8):
        return train_view(u8, size, generator=gen, device=dev)

    if config.TRAIN.IS_SSL:
        lab_dl, unl_dl = train_dl
        lab_u8, _ = _first_rows(lab_dl, 1)
        unl_u8, _ = _first_rows(unl_dl, 1)
        lab = view(lab_u8[:1])
        if config.MODEL.TYPE_SEMI == "CoMatch":
            w, s0, s1 = V.comatch_views(unl_u8[:1], size, generator=gen,
                                        device=dev)
            imgs = [lab[0], w[0], s0[0], s1[0]]
        else:
            w, s = V.fixmatch_views(unl_u8[:1], size, generator=gen,
                                    device=dev)
            imgs = [lab[0], w[0], s[0]]
    else:
        batch_u8, targets = _first_rows(train_dl, 4)
        if config.MODEL.IS_TRIPLET and hasattr(train_dl, "sample"):
            # anchor/pos/neg of the first sample via the loader's
            # random-access protocol (mirrors dataset.py:279-306 sampling)
            t = np.asarray(train_dl.manifest.targets)
            rng = np.random.default_rng(seed)
            pos_pool = np.flatnonzero(t == targets[0])
            neg_pool = np.flatnonzero(t != targets[0])
            if len(neg_pool) == 0:
                neg_pool = pos_pool
            pair = train_dl.sample(np.array(
                [rng.choice(pos_pool), rng.choice(neg_pool)]))
            trio = torch.cat([torch.as_tensor(batch_u8[:1]).to(dev),
                              torch.as_tensor(pair).to(dev)])
            out = view(trio)
            imgs = [out[0], out[1], out[2]]
        else:
            n = min(4, batch_u8.shape[0])
            out = view(batch_u8[:n])
            imgs = [out[i] for i in range(n)]
    arrays = [im.float().cpu().numpy() for im in imgs]
    if reprod:
        # reproduce views are mean/std-0.5 normalized, not ImageNet
        return show_grid(arrays, save_path=save_path, mean=0.5, std=0.5)
    return show_grid(arrays, save_path=save_path)


def show_triplet_dist(d_ap, d_an, save_path: Optional[str] = None):
    """Anchor-positive vs anchor-negative distance histograms
    (utils.py:157-173); returns (d_ap, d_an) arrays."""
    d_ap = np.asarray(d_ap).ravel()
    d_an = np.asarray(d_an).ravel()
    plt = _plt()
    if plt is not None:
        fig, ax = plt.subplots(figsize=(10, 6))
        ax.hist(d_ap, bins=30, alpha=0.6, label="Positive Score", color="skyblue")
        ax.hist(d_an, bins=30, alpha=0.6, label="Negative Score", color="red")
        ax.legend()
        if save_path:
            fig.savefig(save_path, bbox_inches="tight")
        plt.close(fig)
    return d_ap, d_an
