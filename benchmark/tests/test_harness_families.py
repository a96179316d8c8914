"""Trunk families and optimizer references, found by name: a family or an
optimizer that the repository lacks comes as a new file; the ResNet family
and the SGD reference give the numbers the harness gave before they were
split out of it, bit for bit.

    python -m pytest benchmark/tests/test_harness_families.py -q
"""

from __future__ import annotations

import hashlib
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
for p in (str(HERE), str(REPO / "benchmark"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

import toy  # noqa: E402
from rnbench import reference as R  # noqa: E402
from rnbench import train, weights, yardstick  # noqa: E402
from rnbench.spec import Spec  # noqa: E402

# Recorded by the same computations through the harness of commit c34639d,
# the last before the trunk families and optimizer references, on an x86-64
# CPU with one intra-op thread (CPU convolutions sum in another order with
# more threads). sha256 over each key and its tensor's bytes, in order.
PARENT = {
    "sd_resnet18": "62192f8172703d727b596d2e0b3c0070b0cc6f2239d61000cf4fc35a3d9d0dae",
    "sd_resnet50": "6f1b6740f3649917ebf8a23d85f0f1c81d08e9ced57bb40fd7c87656dab9a121",
    "sd_resnet101": "e169b98b6bba980b7f6d98bafdfb28a7473e6ff8151d14be523471acdad2014f",
    "sd_resnet50_head": "86f4a68b0d4aa453da5086c50986166299b701eb10125413c7fbb8add9984f3e",
    "logits": "48f2e4f47203d675c481edb6371eadeaec55ef2327cbf4c096d3a037be84e233",
    "loss": "0x1.2b1e080000000p+3",
    "flops_resnet50": 509539817472,
    "flops_resnet101": 668635011072,
    "sgd_losses": ["0x1.9c406a0000000p+0", "0x1.9878940000000p+0", "0x1.996e040000000p+0"],
    "sgd_grad": "ebf5d943c4db37d149db5ef237ce34f6cfc37d706d34683dd64ab4668b643455",
    "sgd_held": "144983e7add7e11bfca47627f24504acc2c2d484d6f35b751650ce3dbfb28d16",
    "sgd_delta": "10accc68320f88f552344ae7110e0e46b0c02825bf8532984bf6d83364b2b805",
}
SGD = {"class_name": "torch.optim.SGD", "params": {"lr": 0.001, "momentum": 0.9, "weight_decay": 0.001}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.write_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for k, v in tensors.items():
        h.update(k.encode())
        h.update(v.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _model(kind: str, num_classes: int = 90):
    m = {"backbone_kind": kind, "num_classes": num_classes, "min_size": 128, "max_size": 192}
    return Spec(REPO).family({"model": m}), m


# --------------------------------------------------------------------------- #
# A new family, a new optimizer: new files alone
# --------------------------------------------------------------------------- #
def test_the_repository_claims_no_toy_kind_and_the_new_file_does(root):
    with pytest.raises(ValueError, match="0 trunk families"):
        Spec(REPO).family(toy.CONFIG_R34)
    assert Path(Spec(root).family(toy.CONFIG_R34).__file__).name == "toy_resnet34.py"


@pytest.mark.parametrize("cell", ["toy_r34_predict_cell", "toy_r34_train_cell", "toy_adamw_train_cell"])
def test_a_cell_of_a_new_family_or_optimizer_reads_correct(root, cell):
    rc, res, err = toy.run_cell(root, cell)
    assert rc == 0, err
    assert res["correct"] is True, err
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())


def test_the_program_object_reaches_the_program(root):
    from rnbench import predict

    spec = Spec(root)
    traffic = spec.traffic(spec.cell("toy_r34_predict_cell"))
    net, _ = predict.build(toy.CONFIG_R34, traffic, 1, "cpu", spec.family(toy.CONFIG_R34))
    assert net.module.backbone.backbone.remat is True


@pytest.mark.parametrize("kind", ["resnet34", "nope"])
def test_a_kind_needs_exactly_one_family(tmp_path, kind):
    root = toy.write_root(tmp_path)
    if kind == "resnet34":
        shutil.copy(root / "benchmark/families/toy_resnet34.py", root / "benchmark/families/also_34.py")
    with pytest.raises(ValueError, match="exactly one must"):
        Spec(root).family({"model": {"backbone_kind": kind}})


def test_adamw_reference_steps_follow_torch_adamw():
    """Three steps of ``optimizers/adamw.py`` against ``torch.optim.AdamW``
    on a toy model, and the gradient each holds after the first."""
    cfg = {"class_name": "torch.optim.AdamW", "params": {"lr": 0.01, "weight_decay": 0.05}}
    adamw = Spec(REPO).optimizer({"optimizer": cfg})
    gen = torch.Generator().manual_seed(0)
    init = {"w": torch.randn(8, 4, generator=gen), "b": torch.randn(4, generator=gen)}
    xs = [torch.randn(16, 8, generator=gen) for _ in range(3)]

    def loss(p, x):
        return ((x @ p["w"] + p["b"]).tanh() ** 2).mean()

    prog = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    opt = torch.optim.AdamW(prog.values(), lr=0.01, weight_decay=0.05)
    ref = {k: v.clone().requires_grad_(True) for k, v in init.items()}
    state = {}
    for step, x in enumerate(xs):
        opt.zero_grad()
        loss(prog, x).backward()
        opt.step()
        grads = dict(zip(ref, torch.autograd.grad(loss(ref, x), list(ref.values()))))
        with torch.no_grad():
            held = adamw.update(ref, grads, state, step, cfg)
        for k, v in prog.items():
            if step == 0:
                torch.testing.assert_close(held[k], grads[k], rtol=1e-6, atol=0)
                torch.testing.assert_close(adamw.held(opt.state[v], v, cfg), grads[k], rtol=1e-6, atol=0)
            torch.testing.assert_close(ref[k], v, rtol=1e-6, atol=1e-7)
        assert not torch.equal(ref["w"], init["w"])


# --------------------------------------------------------------------------- #
# The parent's numbers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind,num_classes,prior,seed,head_std",
                         [("resnet18", 4, 0.01, 3, None), ("resnet50", 90, 0.01, 2900001801, None),
                          ("resnet101", 90, 0.01, 2900001802, None), ("resnet50", 90, 0.5, 7, 0.0295)])
def test_seeded_state_dicts_are_the_parents(kind, num_classes, prior, seed, head_std):
    fam, m = _model(kind, num_classes)
    sd = weights.make_state_dict(fam, m, prior, seed, "cpu", head_std)
    assert _digest(sd) == PARENT[f"sd_{kind}" + ("_head" if head_std else "")]


def test_reference_logits_and_loss_are_the_parents(one_thread):
    fam, m = _model("resnet18", 4)
    sd = weights.make_state_dict(fam, m, 0.3, 5, "cpu")
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (2, 128, 192, 3), generator=gen, dtype=torch.uint8)
    with torch.no_grad():
        cls, box = R.detector(sd, images, fam, m)
    assert _digest({f"c{i}": c for i, c in enumerate(cls)} | {f"b{i}": b for i, b in enumerate(box)}) \
        == PARENT["logits"]
    boxes = torch.tensor([[[10.0, 20.0, 90.0, 100.0], [0, 0, 0, 0]],
                          [[50.0, 10.0, 150.0, 70.0], [5.0, 5.0, 40.0, 60.0]]])
    labels = torch.tensor([[1, 0], [2, 4]], dtype=torch.int32)
    valid = torch.tensor([[True, False], [True, True]])
    anchors = torch.from_numpy(np.concatenate(R.anchors_per_level((128, 192))))
    c, b = torch.cat(cls, 1), torch.cat(box, 1)
    loss = sum(R.image_loss(c[i], b[i], anchors, boxes[i][valid[i]], labels[i][valid[i]], 4)
               for i in range(2)) / 2
    assert float(loss).hex() == PARENT["loss"]


@pytest.mark.parametrize("kind", ["resnet50", "resnet101"])
def test_detector_flops_are_the_parents(kind):
    fam, m = _model(kind)
    assert yardstick.detector_flops(800, 1344, fam, m) == PARENT[f"flops_{kind}"]


def test_sgd_reference_steps_are_the_parents(one_thread):
    fam, m = _model("resnet18", 4)
    sd = weights.make_state_dict(fam, m, 0.01, 3, "cpu")
    traffic = {"driver": "train", "batch": 2, "batches": 4, "warmup_steps": 5, "min_fg": 4}
    batches = train.make_batches(traffic, 3, 0, (128, 192), 4, "cpu", False)
    ref = train.reference_steps(sd, [[b] for b in batches[:3]], fam, m,
                                Spec(REPO).optimizer({"optimizer": SGD}), SGD, "cpu")
    assert [float(v).hex() for v in ref["losses"]] == PARENT["sgd_losses"]
    for key in ("grad", "held", "delta"):
        assert _digest(ref[key]) == PARENT[f"sgd_{key}"], key


def test_resnet_family_flops_count_every_conv():
    """Basic blocks and bottlenecks alike: the FLOPs of a trunk are those of
    the convs its schema holds, each at its output's size."""
    for kind in ("resnet18", "resnet50"):
        fam, m = _model(kind)
        h, w = 256, 384
        seen = {}

        def spy(x, wt, b=None, stride=1, q=None):
            y = R.conv(x, wt, b, stride, q)
            seen[len(seen)] = 2 * y.shape[2] * y.shape[3] * wt.shape[1] * wt.shape[0] * wt.shape[2] ** 2
            return y

        sd = {k: torch.zeros(s) for k, s, _ in fam.schema(m)}
        sd.update({k: torch.ones(s) for k, s, _ in fam.schema(m) if k.endswith("running_var")})
        with pytest.MonkeyPatch.context() as mp, torch.no_grad():
            mp.setattr(fam, "conv", spy)
            fam.trunk(sd, torch.zeros(1, 3, h, w), m)
        assert fam.trunk_flops(h, w, m) == sum(seen.values())
