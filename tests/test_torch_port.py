"""The PyTorch port (``endoscopy_tpu_torch``) against the JAX package, on the CPU.

The cases are the ``check_*`` functions of ``tests/torch_port_checks/``, one
module for each part of the port: ``models`` (ResNet, heads, the flax →
torch weight conversion), ``randaugment`` (the plain RandAugment and the
kernel wrapper against the Pallas kernel in interpret mode), ``views``,
``serve`` (the serving slice end to end over HTTP, int8 export,
``cli/infer.py``), ``train`` (the FixMatch
training step: losses, schedules, optimizers, EMA, BN statistics, the
labeled view, one step, GRAD_ACCUM and IS_FREEZE), ``learn`` (``cli/learn.py``:
manifests, loaders, metrics, evaluation, checkpoints, a JAX checkpoint's
resume, transfer, ``fit`` and the CLI), ``supervised`` (the supervised
trainer: fresh weights, checkpoint order, class weights, the triplet loss,
the heads, Mixup/CutMix, its steps, ``fit``, the ``evaluate`` and
``pseudo_label`` CLIs), ``comatch`` (the CoMatch trainer: ``grayscale``,
``adjust_hue``, ``comatch_views``, its steps and queue, ``run_config``, the
transfer into ``ModelwEmb``), ``semiformer`` (the Conformer, its conversion,
fresh weights and ``.pth`` graft, the SemiFormer trainer's two steps,
evaluation and ``run_config``, the supervised trainer on the Conformer),
``ezbm`` (the EZBM trainer: the stage-2 sampler, both stages' steps,
``fit``'s stage switch, the Kvasir-Capsule graft, the path H-J presets),
``zoo`` (the rest of the zoo: the SE, gated and grouped ResNets, DenseNet,
Swin, SwinMLP, CoAtNet, ViT-LSA and HaloAttention against flax, one
supervised step each, their ``.pth`` maps, the path K-L presets) and
``nojax`` (the import and device rules); ``models`` also holds the
EfficientNet, the SASA ResNet, their ``.pth`` maps and every preset's and
registry name's parameter count; ``serve`` the side-sized and the
Conformer artifacts. This one test runs every case and reports every failure
with its traceback. It is one test item so that the counts of the JAX
suite that ``PARITY.md`` documents, and ``tests/test_parity_doc.py`` checks
within 2, stay the JAX suite's.
"""

import traceback

import torch

from torch_port_checks import (comatch, ezbm, learn, models, nojax,
                               randaugment, semiformer, serve, supervised,
                               train, views, zoo)

MODULES = (models, randaugment, views, serve, train, learn, supervised,
           comatch, semiformer, ezbm, zoo, nojax)


def _cases():
    return [(f"{mod.__name__}.{name}", fn) for mod in MODULES
            for name, fn in vars(mod).items() if name.startswith("check_")]


def test_port_matches_jax_on_cpu():
    torch.set_num_threads(1)
    cases = _cases()
    assert {mod.__name__ for mod in MODULES} == {
        name.rsplit(".", 1)[0] for name, _ in cases}  # each module has cases
    failures = []
    for name, fn in cases:
        try:
            fn()
        except Exception:
            failures.append(f"{name}\n{traceback.format_exc()}")
    assert not failures, (f"{len(failures)} of {len(cases)} port checks "
                          "failed:\n" + "\n".join(failures))
