"""Swin-T's cell on the CPU: the plain reference against the port's model,
the blocked FixMatch steps against the unblocked ones, the cell's check
against the sound program and against faults, and the readers of the
window attention's span and counter."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from harness import cell, check, spec, traffic, weights
from reference import fixmatch_blocks, swin, train

TINY = dict(img_size=32, patch=4, dim=16, depths=(2, 2), heads=(2, 4),
            window=4)
INIT = {"conv": "lecun", "dense_std": "lecun", "head_scale": 4.0,
        "heads": ["head.fc.weight"]}
CLASSES = 6


def _weights(seed=3):
    with torch.device("meta"):
        names = swin.build("swin_tiny", CLASSES, **TINY)
    return weights.draw(names, INIT, seed, "cpu")


def _reference(w):
    model = swin.build("swin_tiny", CLASSES, **TINY)
    weights.load(model, w)
    return model


def test_tiny_sizes_reach_the_shift_the_mask_and_one_window():
    blocks = [m for m in _reference(_weights()).modules()
              if isinstance(m, swin.SwinBlock)]
    assert [(b.side, b.ws, b.shift) for b in blocks] == [
        (8, 4, 0), (8, 4, 2), (4, 4, 0), (4, 4, 0)]
    assert (blocks[1].attn_mask == -100).any()


def _port(w):
    from endoscopy_tpu_torch.models.heads import ClassifierHead, LinearHead
    from endoscopy_tpu_torch.models.swin import SwinTransformer

    backbone = SwinTransformer(32, patch_size=4, embed_dim=16, depths=(2, 2),
                               num_heads=(2, 4), window_size=4)
    port = ClassifierHead(backbone, LinearHead(backbone.num_features,
                                               CLASSES))
    weights.load(port, w)
    return port


def test_reference_matches_the_port_logits_and_gradients():
    """Float32 on both sides, the same seeded weights loaded by name:
    logits and every parameter's gradient within 1e-5 of the reference's
    largest (the two compute the same operations in the same order).
    The shifted block's mask takes part: the port with it zeroed is off
    by more than 1e-3 of the largest logit."""
    from endoscopy_tpu_torch.models.swin import SwinBlock

    w = _weights()
    ref, port = _reference(w), _port(w)
    x = torch.randn(5, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    a, b = ref(x), port(x)
    assert (a - b).abs().max() <= 1e-5 * a.abs().max()
    (a.square().sum()).backward()
    (b.square().sum()).backward()
    got = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        assert (p.grad - got[name].grad).abs().max() \
            <= 1e-5 * p.grad.abs().max(), name
    for m in port.modules():
        if isinstance(m, SwinBlock) and m.attn_mask is not None:
            m.attn_mask.zero_()
    with torch.no_grad():
        assert (a - port(x)).abs().max() > 1e-3 * a.abs().max()


def test_builds_on_meta_and_counts_the_published_flops():
    from reference.flops import forward_macs, train_flops_per_image

    with torch.device("meta"):
        model = swin.build("swin_tiny_patch4_window7_224", CLASSES)
    assert sum(p.numel() for p in model.parameters()) == 27_523_968
    assert 26.8e9 < train_flops_per_image(model, 224) < 27.0e9
    products = [k for k in forward_macs(model, 224) if k.endswith("products")]
    assert len(products) == 12  # one per block


FIELDS = {"DATA": {"IMG_SIZE": 32},
          "MODEL": {"TYPE_SEMI": "FixMatch"},
          "TRAIN": {"SEED": 11, "EVAL_STEP": 512, "WARMUP_EPOCHS": 5,
                    "BASE_LR": 1e-3, "WARMUP_LR": 5e-4, "EMA_DECAY": 0.999,
                    "THRES": 0.85, "LAMBDA_U": 2}}
B, BU = 4, 8


def _batches():
    g = torch.Generator().manual_seed(5)
    spec_ = spec.cell("swin_fixmatch.cached")["traffic_spec"]
    out = []
    for step in range(3):
        rows = traffic.make_rows(np.arange(B + BU) % CLASSES, 38,
                                 spec_["pattern"], g, "cpu")
        out.append((torch.from_numpy(rows[:B]),
                    torch.arange(step, step + B) % CLASSES,
                    torch.from_numpy(rows[B:])))
    return out


@pytest.fixture(scope="module")
def unblocked():
    w = _weights()
    cw = train.class_weights(np.arange(60) % CLASSES, CLASSES)
    return w, cw, train.run_steps(_reference(w), _batches(), cw, FIELDS, 3)


@pytest.mark.parametrize("block", [1, 3, B + BU])
def test_blocked_steps_equal_the_unblocked_ones(unblocked, block):
    """Losses within 1e-6, the same views, and the check's own numbers on
    the first gradient, the update and the EMA under 1e-4."""
    w, cw, whole = unblocked
    model = _reference(w)
    # the consistency loss takes part: some weak rows pass THRES, some not
    g = torch.Generator().manual_seed(FIELDS["TRAIN"]["SEED"])
    train.views.labeled_draws(g, B)
    weak, _ = train.views.fixmatch_views(
        _batches()[0][2], 32, train.views.fixmatch_draws(g, BU, 32))
    _, mask = fixmatch_blocks._pseudo_labels(model, weak, block,
                                            FIELDS["TRAIN"]["THRES"])
    assert 0 < int(mask.sum()) < BU
    got = fixmatch_blocks.run_steps(model, _batches(), cw, FIELDS, 3,
                                    block=block)
    a, b = (check.reference_readings(r, w) for r in (got, whole))
    numbers = check.compare(a, b, ["head.fc.weight"])
    assert numbers["views_max_abs"] == 0.0
    assert numbers["loss_rel"] < 1e-6
    for key in ("grad_gap", "grad_dist_median", "head_grad_dist",
                "update_gap", "ema_gap"):
        assert numbers[key] < 1e-4, (key, numbers)


TINY_CELL = {"config_spec": {"config": {"DATA": {"BATCH_SIZE": 2, "MU": 1}},
                             "warmup_steps": 1},
             "traffic_spec": {"labeled": 40, "unlabeled": 80}}


@pytest.mark.parametrize("kind", ["sound", cell.ZERO_STEP, cell.HALF_BATCH,
                                  "control"])
def test_cell_correct_only_for_the_sound_program(kind):
    """Swin-T at every published width and 224 px (its stage sides need
    it), B=2, MU=1. A program whose shift masks are zeroed is not among
    the faults: it moves the step less than bf16 does, so the limits set
    for the card's bf16 step cannot refuse it (PERF.md, Open questions)."""
    kw = {}
    if kind in (cell.ZERO_STEP, cell.HALF_BATCH):
        kw["fault"] = kind
    elif kind == "control":
        kw["control"] = True
    result = cell.run("swin_fixmatch.cached", 2 ** 33 + 5, 0.2, False,
                      time.perf_counter(), device="cpu", overrides=TINY_CELL,
                      **kw)
    assert result["correct"] is (kind == "sound"), result["checks"]


MS = 1_000_000  # ns
STEPS = 4
RECORD = {"spans": {"train/step": (160 * MS, 4 * MS, STEPS),
                    "model/window_attention": (30 * MS, 22 * MS, 12 * STEPS)},
          "counters": {"swin/window_logit_bytes": STEPS * 480 * 8_758_848}}


@pytest.fixture
def window(monkeypatch):
    from endoscopy_tpu_torch.utils import trace

    def use(record):
        monkeypatch.setattr(trace, "_last", record)
    return use


def test_window_attention_readers(window):
    ctx = SimpleNamespace(steps=STEPS)
    window(RECORD)
    assert spec.metric_reader("window_attention_host_ms")(ctx) == \
        pytest.approx(5.5)
    assert spec.metric_reader("window_logits_mb_per_step")(ctx) == \
        pytest.approx(4204.24704)
    window({"spans": {"train/step": (1, 1, STEPS)}, "counters": {}})
    for name in ("window_attention_host_ms", "window_logits_mb_per_step"):
        assert spec.metric_reader(name)(ctx) is None
    window(None)
    for name in ("window_attention_host_ms", "window_logits_mb_per_step"):
        assert spec.metric_reader(name)(ctx) is None
