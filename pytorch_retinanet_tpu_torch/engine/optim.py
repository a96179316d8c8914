"""Optimizer and LR-scheduler registry: torch config names onto ``torch.optim``.

Counterpart of ``pytorch_retinanet_tpu/engine/optim.py``. The config surface
is the reference's (``class_name`` by dotted torch path plus ``params``,
``hparams.yaml:36-55``); the numbers follow the JAX package's optax chains
wherever torch's defaults differ from them:

* SGD: coupled L2 before momentum, trace ``m = g + mu * m``, update
  ``-lr * m``: ``torch.optim.SGD`` with dampening 0. ``dampening`` is
  accepted and ignored, as optax has none.
* Adam with coupled L2 (``torch.optim.Adam``) and AdamW (``lr * wd * p``,
  ``torch.optim.AdamW``).
* RMSprop puts eps inside the square root and the momentum trace after the
  learning rate, as ``optax.rmsprop`` does; ``torch.optim.RMSprop`` puts eps
  outside, so the port has its own :class:`RMSprop`.

The learning rate and momentum live in ``param_groups``; the Trainer writes
them between steps (:func:`set_learning_rate`, :func:`set_momentum`). The
schedulers are plain Python and produce absolute LRs, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Sequence

import torch

Tensor = torch.Tensor


# --------------------------------------------------------------------------- #
# Optimizers
# --------------------------------------------------------------------------- #
class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop`` (with coupled L2 in front, as the JAX registry
    builds it): ``nu = (1 - alpha) g^2 + alpha nu``; ``u = lr * g / sqrt(nu
    + eps)``; with momentum ``m = u + momentum * m`` and ``p -= m``, else
    ``p -= u``."""

    def __init__(self, params, lr: float = 1e-2, alpha: float = 0.99, eps: float = 1e-8,
                 momentum: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr, alpha, eps = group["lr"], group["alpha"], group["eps"]
            momentum, wd = group["momentum"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad if not wd else p.grad + wd * p
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.copy_((1.0 - alpha) * g * g + alpha * nu)
                u = torch.rsqrt(nu + eps) * g * lr
                if momentum:
                    if "trace" not in state:
                        state["trace"] = torch.zeros_like(p)
                    u = state["trace"].mul_(momentum).add_(u)
                p.sub_(u)
        return loss


def _sgd(parameters, lr: float, momentum: float = 0.0, weight_decay: float = 0.0,
         nesterov: bool = False, dampening: float = 0.0) -> torch.optim.Optimizer:
    del dampening  # optax.sgd has none; the JAX registry ignores it too
    return torch.optim.SGD(parameters, lr=lr, momentum=momentum or 0.0, dampening=0.0,
                           weight_decay=weight_decay, nesterov=nesterov)


def _adam(parameters, lr: float, betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
          weight_decay: float = 0.0) -> torch.optim.Optimizer:
    return torch.optim.Adam(parameters, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


def _adamw(parameters, lr: float, betas: Sequence[float] = (0.9, 0.999), eps: float = 1e-8,
           weight_decay: float = 0.01) -> torch.optim.Optimizer:
    return torch.optim.AdamW(parameters, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


def _rmsprop(parameters, lr: float, alpha: float = 0.99, eps: float = 1e-8,
             momentum: float = 0.0, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    return RMSprop(parameters, lr=lr, alpha=alpha, eps=eps, momentum=momentum or 0.0,
                   weight_decay=weight_decay)


OPTIMIZER_REGISTRY: Dict[str, Callable[..., torch.optim.Optimizer]] = {
    "torch.optim.SGD": _sgd,
    "torch.optim.Adam": _adam,
    "torch.optim.AdamW": _adamw,
    "torch.optim.RMSprop": _rmsprop,
    "optax.sgd": _sgd,
    "optax.adam": _adam,
    "optax.adamw": _adamw,
    "SGD": _sgd,
    "Adam": _adam,
    "AdamW": _adamw,
    "RMSprop": _rmsprop,
}


def build_optimizer(
    class_name: str,
    parameters: Iterable[Tensor],
    params: Optional[Mapping[str, Any]] = None,
    *,
    flatten: bool = False,
) -> torch.optim.Optimizer:
    """Resolve an optimizer config (``class_name`` and its ``params``) to a
    ``torch.optim`` optimizer over `parameters`.

    ``flatten`` is accepted for config compatibility: in the JAX package it
    only changes the checkpoint layout of the optimizer state (one raveled
    vector), and it has no effect here.
    """
    del flatten
    if class_name not in OPTIMIZER_REGISTRY:
        raise KeyError(f"unknown optimizer {class_name!r}; available: {sorted(OPTIMIZER_REGISTRY)}")
    kwargs = dict(params or {})
    lr = kwargs.pop("lr", kwargs.pop("learning_rate", 1e-3))
    return OPTIMIZER_REGISTRY[class_name](parameters, lr, **kwargs)


def clip_grad_norm(parameters: Iterable[Tensor], max_norm: float) -> Tensor:
    """Scale the gradients by ``min(1, max_norm / max(global_norm, 1e-12))``,
    the JAX train step's clip; returns the global norm before clipping."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)
    return norm


class GradientAccumulation:
    """Window-mean gradient accumulation in front of an optimizer.

    The counterpart of ``optax.MultiSteps`` as :func:`wrap_accumulation`
    builds it. Each micro-batch's ``backward`` adds into ``.grad``;
    :meth:`step` counts the micro-batch and, when the window of ``every``
    is full, divides the gradients by ``every`` (their mean), clips that
    mean to ``clip_norm`` when set, steps the optimizer and clears the
    gradients. :meth:`flush` closes a partial window the same way, which is
    the mean over ``every`` with zeros for the missing micro-batches, as
    feeding optax zero gradients gives.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, every: int,
                 clip_norm: Optional[float] = None):
        if every <= 1:
            raise ValueError(f"accumulation window must be >= 2, got {every}")
        self.optimizer = optimizer
        self.every = every
        self.clip_norm = clip_norm
        self.mini_step = 0

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    def _params(self):
        return [p for g in self.param_groups for p in g["params"] if p.grad is not None]

    def step(self) -> bool:
        """Count one micro-batch; True when the optimizer stepped."""
        self.mini_step += 1
        if self.mini_step < self.every:
            return False
        self._apply()
        return True

    def state_dict(self) -> Dict[str, Any]:
        """The optimizer's state. Checkpoints are written at window
        boundaries, where nothing is accumulated."""
        return self.optimizer.state_dict()

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.optimizer.load_state_dict(state)
        self.mini_step = 0

    def flush(self) -> bool:
        """Step on a partial window, if there is one."""
        if not self.mini_step:
            return False
        self._apply()
        return True

    def _apply(self) -> None:
        params = self._params()
        for p in params:
            p.grad.div_(self.every)
        if self.clip_norm:
            clip_grad_norm(params, self.clip_norm)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.mini_step = 0


def wrap_accumulation(optimizer: torch.optim.Optimizer, every: int,
                      clip_norm: Optional[float] = None) -> GradientAccumulation:
    """Average gradients over ``every`` micro-batches and step once per
    window, clipping the window mean at optimizer-step time."""
    return GradientAccumulation(optimizer, every, clip_norm)


def set_learning_rate(optimizer, lr: float):
    """Write `lr` into every param group (through an accumulation wrapper)."""
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def current_learning_rate(optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_momentum(optimizer, momentum: float):
    """Write `momentum` into the param groups of an optimizer built with a
    non-zero momentum; a no-op for the others (momentum-free SGD, Adam), as
    the JAX package injects momentum only where it was configured."""
    for group in optimizer.param_groups:
        if group.get("momentum"):
            group["momentum"] = momentum
    return optimizer


# --------------------------------------------------------------------------- #
# LR schedulers (torch.optim.lr_scheduler semantics, host-side state)
# --------------------------------------------------------------------------- #
SCHEDULER_STATE_VERSION = 1


class LRScheduler:
    """Base: an absolute LR from the step/epoch counter (and a metric)."""

    needs_metric = False

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.t = 0

    def step(self, metric: Optional[float] = None) -> float:
        self.t += 1
        return self.lr_at(self.t)

    def state_dict(self) -> Dict[str, Any]:
        """Versioned snapshot: every non-callable attribute, the schema
        version and the class name."""
        state = {k: v for k, v in self.__dict__.items() if not callable(v)}
        return {"version": SCHEDULER_STATE_VERSION, "class": type(self).__name__, "state": state}

    def load_state_dict(self, sd: Mapping[str, Any]) -> None:
        """Strict restore: raises on a schema-version, class or attribute-set
        mismatch."""
        if not isinstance(sd, Mapping) or "state" not in sd:
            raise ValueError("scheduler checkpoint is not a state_dict() snapshot "
                             f"(got {type(sd).__name__}); expected keys version/class/state")
        if sd.get("version") != SCHEDULER_STATE_VERSION:
            raise ValueError(f"scheduler checkpoint schema version {sd.get('version')!r} "
                             f"!= supported {SCHEDULER_STATE_VERSION}")
        if sd.get("class") != type(self).__name__:
            raise ValueError(f"scheduler checkpoint was saved by {sd.get('class')!r} but is "
                             f"being restored into {type(self).__name__!r}")
        current = {k for k, v in self.__dict__.items() if not callable(v)}
        saved = set(sd["state"])
        if saved != current:
            raise ValueError(f"scheduler state keys do not match {type(self).__name__}: "
                             f"checkpoint is missing {sorted(current - saved)}, has "
                             f"unexpected {sorted(saved - current)}")
        self.__dict__.update(sd["state"])

    def lr_at(self, t: int) -> float:  # pragma: no cover
        raise NotImplementedError

    def initial_lr(self) -> float:
        """LR before the first step (torch applies lr_at(0) at construction)."""
        return self.base_lr

    def momentum_at(self, t: int) -> Optional[float]:
        """Momentum override at step t; None for schedulers that do not cycle it."""
        return None


class ConstantLR(LRScheduler):
    def lr_at(self, t: int) -> float:
        return self.base_lr


class CosineAnnealingLR(LRScheduler):
    def __init__(self, base_lr: float, T_max: int, eta_min: float = 0.0):
        super().__init__(base_lr)
        self.T_max = T_max
        self.eta_min = eta_min

    def lr_at(self, t: int) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * min(t, self.T_max) / self.T_max)
        ) / 2


class StepLR(LRScheduler):
    def __init__(self, base_lr: float, step_size: int, gamma: float = 0.1):
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma

    def lr_at(self, t: int) -> float:
        return self.base_lr * self.gamma ** (t // self.step_size)


class MultiStepLR(LRScheduler):
    def __init__(self, base_lr: float, milestones: Sequence[int], gamma: float = 0.1):
        super().__init__(base_lr)
        self.milestones = sorted(milestones)
        self.gamma = gamma

    def lr_at(self, t: int) -> float:
        k = sum(1 for m in self.milestones if m <= t)
        return self.base_lr * self.gamma**k


class ReduceLROnPlateau(LRScheduler):
    """Driven by the monitored metric; ``verbose``, ``threshold_mode`` and
    ``eps`` are accepted and ignored."""

    needs_metric = True

    def __init__(self, base_lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4, min_lr: float = 0.0,
                 cooldown: int = 0, **torch_only):
        super().__init__(base_lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.cooldown = cooldown
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.cooldown_left = 0
        self.lr = base_lr

    def _improved(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            return metric < self.best - self.threshold
        return metric > self.best + self.threshold

    def step(self, metric: Optional[float] = None) -> float:
        self.t += 1
        if metric is None:
            return self.lr
        if self._improved(metric):
            self.best = metric
            self.bad_epochs = 0
        elif self.cooldown_left > 0:
            self.cooldown_left -= 1
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad_epochs = 0
                self.cooldown_left = self.cooldown
        return self.lr


class LambdaLR(LRScheduler):
    """lr = base_lr * lr_lambda(t); ``lr_lambda`` must be callable."""

    def __init__(self, base_lr: float, lr_lambda: Callable[[int], float]):
        super().__init__(base_lr)
        if not callable(lr_lambda):
            raise TypeError("LambdaLR requires a callable lr_lambda")
        self.lr_lambda = lr_lambda

    def lr_at(self, t: int) -> float:
        return self.base_lr * self.lr_lambda(t)

    def initial_lr(self) -> float:
        return self.lr_at(0)


class ExponentialLR(LRScheduler):
    def __init__(self, base_lr: float, gamma: float):
        super().__init__(base_lr)
        self.gamma = gamma

    def lr_at(self, t: int) -> float:
        return self.base_lr * self.gamma**t


class LinearLR(LRScheduler):
    """Linear factor ramp start_factor -> end_factor over total_iters steps."""

    def __init__(self, base_lr: float, start_factor: float = 1.0 / 3.0,
                 end_factor: float = 1.0, total_iters: int = 5):
        super().__init__(base_lr)
        self.start_factor = start_factor
        self.end_factor = end_factor
        self.total_iters = total_iters

    def lr_at(self, t: int) -> float:
        frac = min(t, self.total_iters) / self.total_iters
        return self.base_lr * (self.start_factor + (self.end_factor - self.start_factor) * frac)

    def initial_lr(self) -> float:
        return self.lr_at(0)


class CosineAnnealingWarmRestarts(LRScheduler):
    """SGDR: cosine cycles of length T_0, T_0 * T_mult, T_0 * T_mult^2, ..."""

    def __init__(self, base_lr: float, T_0: int, T_mult: int = 1, eta_min: float = 0.0):
        super().__init__(base_lr)
        if T_0 <= 0 or T_mult < 1:
            raise ValueError("T_0 must be > 0 and T_mult >= 1")
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min

    def lr_at(self, t: int) -> float:
        if self.T_mult == 1:
            T_i, T_cur = self.T_0, t % self.T_0
        else:
            n = int(math.log(t * (self.T_mult - 1) / self.T_0 + 1, self.T_mult))
            T_i = self.T_0 * self.T_mult**n
            T_cur = t - self.T_0 * (self.T_mult**n - 1) // (self.T_mult - 1)
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * T_cur / T_i)
        ) / 2


class OneCycleLR(LRScheduler):
    """Ramp max_lr/div_factor -> max_lr over pct_start of total_steps, then
    anneal to max_lr/(div_factor*final_div_factor); with ``cycle_momentum``
    the momentum cycles inversely (max -> base -> max). A step-interval
    scheduler (``interval: step``)."""

    def __init__(self, base_lr: float, max_lr: float, total_steps: int, pct_start: float = 0.3,
                 anneal_strategy: str = "cos", div_factor: float = 25.0,
                 final_div_factor: float = 1e4, cycle_momentum: bool = True,
                 base_momentum: float = 0.85, max_momentum: float = 0.95, **torch_only):
        super().__init__(base_lr)
        if anneal_strategy not in ("cos", "linear"):
            raise ValueError(f"unknown anneal_strategy {anneal_strategy!r}")
        self.max_lr = max_lr
        self.total_steps = total_steps
        self.pct_start = pct_start
        self.anneal_strategy = anneal_strategy
        self.init_lr = max_lr / div_factor
        self.min_lr = self.init_lr / final_div_factor
        self.cycle_momentum = cycle_momentum
        self.base_momentum = base_momentum
        self.max_momentum = max_momentum

    def _anneal(self, start: float, end: float, frac: float) -> float:
        if self.anneal_strategy == "cos":
            return end + (start - end) * (1 + math.cos(math.pi * frac)) / 2
        return start + (end - start) * frac

    def _phase(self, t: int, up: tuple, down: tuple) -> float:
        t = min(t, self.total_steps)
        up_steps = float(self.pct_start * self.total_steps) - 1
        # A degenerate up phase (pct_start * total_steps <= 1) has no up
        # steps: t = 0 starts at the down phase's peak.
        if up_steps > 0 and t <= up_steps:
            return self._anneal(*up, t / up_steps)
        up_steps = max(up_steps, 0.0)
        down_steps = self.total_steps - up_steps - 1
        return self._anneal(*down, (t - up_steps) / down_steps)

    def lr_at(self, t: int) -> float:
        return self._phase(t, (self.init_lr, self.max_lr), (self.max_lr, self.min_lr))

    def initial_lr(self) -> float:
        return self.init_lr

    def momentum_at(self, t: int) -> Optional[float]:
        if not self.cycle_momentum:
            return None
        return self._phase(t, (self.max_momentum, self.base_momentum),
                           (self.base_momentum, self.max_momentum))


def warmup_scale(step: int, warmup_steps: int, warmup_factor: float) -> float:
    """Linear LR warmup multiplier, ``warmup_factor`` -> 1 over
    ``warmup_steps`` optimizer steps."""
    if warmup_steps <= 0 or step >= warmup_steps:
        return 1.0
    alpha = step / warmup_steps
    return warmup_factor * (1.0 - alpha) + alpha


SCHEDULER_REGISTRY: Dict[str, type] = {}
for _cls in (CosineAnnealingLR, CosineAnnealingWarmRestarts, StepLR, MultiStepLR,
             ReduceLROnPlateau, ConstantLR, LambdaLR, ExponentialLR, LinearLR, OneCycleLR):
    SCHEDULER_REGISTRY[_cls.__name__] = _cls
    SCHEDULER_REGISTRY[f"torch.optim.lr_scheduler.{_cls.__name__}"] = _cls


def build_scheduler(class_name: Optional[str], base_lr: float,
                    params: Optional[Mapping[str, Any]] = None) -> LRScheduler:
    """Resolve a scheduler config (``class_name`` and its ``params``);
    none is a constant LR."""
    if not class_name:
        return ConstantLR(base_lr)
    if class_name not in SCHEDULER_REGISTRY:
        raise KeyError(f"unknown scheduler {class_name!r}; available: {sorted(SCHEDULER_REGISTRY)}")
    kwargs = dict(params or {})
    for torch_only in ("verbose", "threshold_mode", "eps", "last_epoch"):
        kwargs.pop(torch_only, None)
    return SCHEDULER_REGISTRY[class_name](base_lr, **kwargs)
