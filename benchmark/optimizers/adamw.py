"""torch.optim.AdamW's update as the reference takes it: Adam's moments with
bias correction, and the weight decay decoupled from the gradient
(Loshchilov and Hutter, arXiv:1711.05101). The contract is
``optimizers/sgd.py``'s. The configuration's ``betas``, ``eps`` and
``weight_decay`` default to torch.optim.AdamW's."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _hyper(opt: Dict) -> Tuple[float, float, float, float, float]:
    p = opt["params"]
    b1, b2 = p.get("betas", (0.9, 0.999))
    return (float(p["lr"]), float(b1), float(b2), float(p.get("eps", 1e-8)),
            float(p.get("weight_decay", 1e-2)))


def update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], state: Dict, step: int,
           opt: Dict) -> Dict[str, torch.Tensor]:
    """``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, then
    ``p = p (1 - lr wd) - lr m^ / (sqrt(v^) + eps)`` with ``m^ = m / (1 -
    b1^t)``, ``v^ = v / (1 - b2^t)``. Returns ``m / (1 - b1)``: after the
    first step, the gradient itself."""
    lr, b1, b2, eps, wd = _hyper(opt)
    t = step + 1
    out = {}
    for k, g in grads.items():
        if step == 0:
            state[k] = (torch.zeros_like(g), torch.zeros_like(g))
        m, v = state[k]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        m_hat, v_hat = m / (1 - b1 ** t), v / (1 - b2 ** t)
        params[k].mul_(1 - lr * wd).sub_(lr * m_hat / (v_hat.sqrt() + eps))
        out[k] = m / (1 - b1)
    return out


def held(state: Dict, param: torch.Tensor, opt: Dict) -> torch.Tensor:
    """``exp_avg / (1 - beta1)``, which after the first step is the gradient."""
    _, b1, _, _, _ = _hyper(opt)
    return state["exp_avg"] / (1 - b1) if "exp_avg" in state else torch.zeros_like(param)
