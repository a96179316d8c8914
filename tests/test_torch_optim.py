"""Optimizers, schedulers, warmup and accumulation of the port vs the JAX package (CPU).

Every registered optimizer name runs 10 steps on the same parameters and
the same numpy gradients in the port (``torch.optim`` and the port's own
RMSprop) and in the JAX package's optax chain, with the learning rate
changed between steps as warmup does. Tolerance: parameters within 1e-6
relative + 1e-7 absolute after every step (f32; torch and optax order the
same arithmetic differently, e.g. Adam's bias corrections).

The ten schedulers, ``warmup_scale`` and the accumulation wrapper are
plain arithmetic: LR and momentum sequences equal the JAX classes' to
1e-12 relative, the accumulated parameters within the optimizer tolerance.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytorch_retinanet_tpu.engine import optim as jax_optim
from pytorch_retinanet_tpu_torch.engine import optim

SHAPES = [(5, 3), (7,)]


def _grads(seed, steps=10):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal(s).astype(np.float32) for s in SHAPES] for _ in range(steps)]


def _init(seed):
    rng = np.random.default_rng(100 + seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


def _run_jax(name, cfg, init, grads, lrs, wrap=None):
    tx = jax_optim.build_optimizer(name, cfg)
    if wrap:
        tx = jax_optim.wrap_accumulation(tx, *wrap)
    params = [jnp.asarray(p) for p in init]
    state = tx.init(params)
    update = jax.jit(tx.update)
    out = []
    for g, lr in zip(grads, lrs):
        state = jax_optim.set_learning_rate(state, lr)
        upd, state = update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, upd)
        out.append([np.asarray(p) for p in params])
    return out


def _run_port(name, cfg, init, grads, lrs):
    params = [torch.tensor(p, requires_grad=True) for p in init]
    opt = optim.build_optimizer(name, params, cfg)
    out = []
    for g, lr in zip(grads, lrs):
        optim.set_learning_rate(opt, lr)
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
        out.append([p.detach().numpy().copy() for p in params])
    return out


def _assert_runs_close(got, want):
    for step, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=f"step {step}")


SGD_CFGS = [{"lr": 0.01, "momentum": 0.9, "weight_decay": 1e-3},
            {"lr": 0.01, "momentum": 0.9, "nesterov": True},
            {"lr": 0.05},
            {"lr": 0.01, "momentum": 0.5, "dampening": 0.3}]
ADAM_CFGS = [{"lr": 1e-3}, {"lr": 1e-3, "weight_decay": 1e-2, "betas": (0.8, 0.99), "eps": 1e-6}]
ADAMW_CFGS = [{"lr": 1e-3}, {"lr": 1e-3, "weight_decay": 0.1}]
RMS_CFGS = [{"lr": 1e-3}, {"lr": 1e-3, "momentum": 0.9, "weight_decay": 1e-3, "eps": 1e-4},
            {"lr": 1e-2, "alpha": 0.9, "eps": 0.5}]
_KIND_CFGS = {"SGD": SGD_CFGS, "sgd": SGD_CFGS, "Adam": ADAM_CFGS, "adam": ADAM_CFGS,
              "AdamW": ADAMW_CFGS, "adamw": ADAMW_CFGS, "RMSprop": RMS_CFGS}
CASES = [(name, i) for name in sorted(jax_optim.OPTIMIZER_REGISTRY)
         for i in range(len(_KIND_CFGS[name.split(".")[-1]]))]


def test_registries_have_the_same_names():
    assert sorted(optim.OPTIMIZER_REGISTRY) == sorted(jax_optim.OPTIMIZER_REGISTRY)
    assert sorted(optim.SCHEDULER_REGISTRY) == sorted(jax_optim.SCHEDULER_REGISTRY)


@pytest.mark.parametrize("name,i", CASES)
def test_optimizer_matches_optax_chain(name, i):
    cfg = _KIND_CFGS[name.split(".")[-1]][i]
    init, grads = _init(i), _grads(i)
    base = cfg["lr"]
    lrs = [base * (0.1 + 0.09 * t) for t in range(10)]  # a warmup ramp
    _assert_runs_close(_run_port(name, dict(cfg), init, grads, lrs),
                       _run_jax(name, dict(cfg), init, grads, lrs))


def test_rmsprop_puts_eps_inside_the_root():
    """One step of RMSprop with a large eps: optax's g / sqrt(nu + eps), not
    torch's g / (sqrt(nu) + eps)."""
    p = torch.tensor([1.0], requires_grad=True)
    opt = optim.build_optimizer("torch.optim.RMSprop", [p], {"lr": 1.0, "alpha": 0.0, "eps": 3.0})
    p.grad = torch.tensor([1.0])
    opt.step()
    assert math.isclose(1.0 - p.item(), 1.0 / math.sqrt(1.0 + 3.0), rel_tol=1e-6)


def test_unknown_optimizer_and_flatten():
    with pytest.raises(KeyError):
        optim.build_optimizer("torch.optim.LBFGS", [torch.zeros(1, requires_grad=True)])
    opt = optim.build_optimizer("SGD", [torch.zeros(1, requires_grad=True)], {"lr": 0.1},
                                flatten=True)
    assert isinstance(opt, torch.optim.SGD) and optim.current_learning_rate(opt) == 0.1


def test_set_momentum_writes_only_where_momentum_was_configured():
    p = [torch.zeros(2, requires_grad=True)]
    sgd = optim.build_optimizer("SGD", p, {"lr": 0.1, "momentum": 0.9})
    optim.set_momentum(sgd, 0.85)
    assert sgd.param_groups[0]["momentum"] == 0.85
    plain = optim.build_optimizer("SGD", p, {"lr": 0.1})
    optim.set_momentum(plain, 0.85)
    assert plain.param_groups[0]["momentum"] == 0.0
    adam = optim.build_optimizer("Adam", p, {"lr": 0.1})
    optim.set_momentum(adam, 0.85)
    assert "momentum" not in adam.param_groups[0]
    # The JAX package: momentum is injectable exactly where it was configured.
    state = jax_optim.build_optimizer("SGD", {"lr": 0.1, "momentum": 0.9}).init([jnp.zeros(2)])
    assert float(jax_optim.set_momentum(state, 0.85).hyperparams["momentum"]) == pytest.approx(0.85)


SCHEDULERS = {
    "ConstantLR": {},
    "CosineAnnealingLR": {"T_max": 7, "eta_min": 1e-4},
    "CosineAnnealingWarmRestarts": {"T_0": 3, "T_mult": 2, "eta_min": 1e-5},
    "StepLR": {"step_size": 4, "gamma": 0.5},
    "MultiStepLR": {"milestones": [9, 3], "gamma": 0.3},
    "ReduceLROnPlateau": {"mode": "min", "factor": 0.5, "patience": 1, "cooldown": 1,
                          "verbose": True, "threshold_mode": "rel"},
    "LambdaLR": {"lr_lambda": lambda t: 1.0 / (1 + t)},
    "ExponentialLR": {"gamma": 0.9},
    "LinearLR": {"start_factor": 0.25, "total_iters": 6},
    "OneCycleLR": {"max_lr": 0.1, "total_steps": 20, "pct_start": 0.25},
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_sequence_matches_jax(name):
    full = f"torch.optim.lr_scheduler.{name}"
    ours = optim.build_scheduler(full, 0.02, dict(SCHEDULERS[name]))
    theirs = jax_optim.build_scheduler(full, 0.02, dict(SCHEDULERS[name]))
    assert type(ours).__name__ == type(theirs).__name__ == name
    assert ours.initial_lr() == pytest.approx(theirs.initial_lr(), rel=1e-12)
    assert ours.momentum_at(0) == theirs.momentum_at(0)
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8, 0.9] * 2
    for t, m in enumerate(metrics):
        arg = m if ours.needs_metric else None
        assert ours.step(arg) == pytest.approx(theirs.step(arg), rel=1e-12), f"step {t}"
        want_m = theirs.momentum_at(theirs.t)
        got_m = ours.momentum_at(ours.t)
        assert (got_m is None) == (want_m is None)
        if want_m is not None:
            assert got_m == pytest.approx(want_m, rel=1e-12)
    if name != "LambdaLR":  # a callable is no state, in both packages
        sd = ours.state_dict()
        assert sd["state"] == theirs.state_dict()["state"]
        fresh = optim.build_scheduler(full, 0.02, dict(SCHEDULERS[name]))
        fresh.load_state_dict(sd)
        assert fresh.step(0.1 if fresh.needs_metric else None) == ours.step(
            0.1 if ours.needs_metric else None)


def test_scheduler_restore_rejects_a_mismatch():
    sd = optim.build_scheduler("StepLR", 0.1, {"step_size": 2}).state_dict()
    with pytest.raises(ValueError, match="saved by"):
        optim.build_scheduler("ExponentialLR", 0.1, {"gamma": 0.5}).load_state_dict(sd)
    assert isinstance(optim.build_scheduler(None, 0.1), optim.ConstantLR)
    with pytest.raises(KeyError):
        optim.build_scheduler("CyclicLR", 0.1)


def test_warmup_scale_matches_jax():
    for warm in (0, 1, 5, 500):
        for step in range(0, 12):
            assert optim.warmup_scale(step, warm, 0.001) == jax_optim.warmup_scale(step, warm, 0.001)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_accumulation_matches_wrap_accumulation(clip):
    """Windows of 3 over 7 micro-batches, then the partial window closed as
    the JAX trainer closes it (zero gradients to the window's end)."""
    cfg = {"lr": 0.05, "momentum": 0.9, "weight_decay": 1e-3}
    init, grads = _init(7), _grads(7, steps=7)
    zeros = [np.zeros(s, np.float32) for s in SHAPES]
    lrs = [0.05] * 9
    want = _run_jax("torch.optim.SGD", cfg, init, grads + [zeros, zeros], lrs, wrap=(3, clip))

    params = [torch.tensor(p, requires_grad=True) for p in init]
    acc = optim.wrap_accumulation(optim.build_optimizer("torch.optim.SGD", params, cfg), 3, clip)
    got, stepped = [], []
    for g in grads:
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy()) if p.grad is None else p.grad + torch.from_numpy(x)
        stepped.append(acc.step())
        got.append([p.detach().numpy().copy() for p in params])
    assert stepped == [False, False, True, False, False, True, False]
    assert acc.flush() and not acc.flush()
    got.append([p.detach().numpy().copy() for p in params])
    _assert_runs_close(got, want[:7] + [want[8]])
    with pytest.raises(ValueError):
        optim.wrap_accumulation(acc.optimizer, 1)
