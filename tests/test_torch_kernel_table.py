"""``tools/torch_kernel_table.py`` on the CPU: its registry of cases and the
shapes it shares with the card tests (the timings need the card)."""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tools"))
import torch_kernel_table as table  # noqa: E402

from pytorch_retinanet_tpu_torch import kernels  # noqa: E402


def test_every_registry_kernel_has_a_case():
    assert set(table.CASES) == {k.name for k in kernels.KERNELS}
    assert [k.name for k, _ in table.cases_for([])] == [k.name for k in kernels.KERNELS]
    assert [k.name for k, _ in table.cases_for(["focal_loss"])] == ["focal_loss"]


def test_a_kernel_without_a_case_or_an_unknown_name_raises(monkeypatch):
    with pytest.raises(KeyError, match="not in kernels.KERNELS"):
        table.cases_for(["no_such_kernel"])
    extra = kernels.Kernel("new_kernel", kernels.top2_classes, "cuda", "csrc/new.cu", "none")
    monkeypatch.setattr(kernels, "KERNELS", kernels.KERNELS + (extra,))
    with pytest.raises(KeyError, match="without a case"):
        table.cases_for([])


def test_r50_frozen_bn_shapes_are_the_trunk_s():
    """The 53 shapes the card tests and the table use are the BN inputs of
    R-50's trunk, in the order a forward meets them."""
    from pytorch_retinanet_tpu_torch.models import RetinaNetModule
    from pytorch_retinanet_tpu_torch.models.layers import BatchNorm2d

    module = RetinaNetModule(backbone_kind="resnet50", num_classes=4, dtype=torch.float32)
    module.reset_parameters(torch.Generator().manual_seed(0))
    module.eval()
    seen = []
    for m in module.backbone.modules():
        if isinstance(m, BatchNorm2d):
            m.register_forward_hook(lambda mod, args, out: seen.append(tuple(args[0].shape)))
    with torch.no_grad():
        module(torch.rand(2, 64, 96, 3), return_levels=True)
    assert seen == [s[:4] for s in table.r50_frozen_bn_shapes(2, 64, 96)]
