"""torch.optim.SGD's update as the reference takes it: momentum, the weight
decay added to the gradient, no dampening, no Nesterov.

An optimizer reference is a file of ``benchmark/optimizers/``, named by the
last component of the configuration's ``optimizer.class_name`` in lower
case, that gives:

- ``update(params, grads, state, step, opt)``: one step (`step` from 0) of
  the optimizer on the dict `params` in place, from the dict `grads`, with
  `state` (a dict the caller keeps across steps) and `opt` (the
  configuration's ``optimizer``); returns per key the gradient as the
  optimizer holds it after the step;
- ``held(state, param, opt)``: that gradient read from the program's
  optimizer, ``state`` being its ``optimizer.state[param]``, after the
  program's first step.
"""

from __future__ import annotations

from typing import Dict

import torch


def update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: Dict, step: int,
           opt: Dict) -> Dict[str, torch.Tensor]:
    """The momentum buffer: ``g + weight_decay * p`` at the first step, then
    ``momentum * buffer + g + weight_decay * p``; ``p -= lr * buffer``."""
    lr, wd, mom = (float(opt["params"][k]) for k in ("lr", "weight_decay", "momentum"))
    for k, g in grads.items():
        d = g + wd * params[k]
        state[k] = d.clone() if step == 0 else state[k].mul_(mom).add_(d)
        params[k].sub_(lr * state[k])
    return state


def held(state: Dict, param: torch.Tensor, opt: Dict) -> torch.Tensor:
    """The momentum buffer, which after the first step is ``g + weight_decay * p``."""
    return state["momentum_buffer"] if "momentum_buffer" in state else torch.zeros_like(param)
