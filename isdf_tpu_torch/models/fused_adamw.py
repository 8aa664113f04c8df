"""AdamW with optax.adamw's state semantics (count, mu, nu), updating the
parameters and moments in place (isdf_tpu/models/fused_adamw.py):

    m <- b1 m + (1-b1) g          mhat = m / (1 - b1^t)
    v <- b2 v + (1-b2) g^2        vhat = v / (1 - b2^t)
    p <- p - lr_scale * lr * (mhat / (sqrt(vhat) + eps) + wd p)

``lr_scale`` folds in the refinement-tail decay: scaling the whole update
by s equals adamw(lr * s) at that step. The step count is an int32 tensor
on the parameters' device, as optax keeps it, and the bias corrections are
computed there in float32 (isdf_tpu fused_adamw.py:41-44), so an update
needs nothing from the host and a CUDA graph can replay it.
"""

from __future__ import annotations

from typing import Dict

import torch


def init_state(params: Dict[str, torch.Tensor]):
    dev = next(iter(params.values())).device
    return {"count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def make_fused_adamw(lr: float, weight_decay: float, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8):
    """Returns apply(params, grads, state, lr_scale) -> (params, state),
    both updated in place; lr_scale a number or a float32 tensor on the
    parameters' device."""

    def apply(params, grads, state, lr_scale=1.0):
        count = state["count"]
        count.add_(1)
        t = count.float()
        c1 = 1.0 / (1.0 - torch.pow(b1, t))
        c2 = 1.0 / (1.0 - torch.pow(b2, t))
        if not isinstance(lr_scale, torch.Tensor):
            lr_scale = torch.full((), lr_scale, device=t.device)
        step = lr_scale * lr
        for k, p in params.items():
            g, m, v = grads[k], state["mu"][k], state["nu"][k]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).add_((1.0 - b2) * g * g)
            u = (m * c1) / (torch.sqrt(v * c2) + eps) + weight_decay * p
            p.sub_(step * u)
        return params, state

    return apply
