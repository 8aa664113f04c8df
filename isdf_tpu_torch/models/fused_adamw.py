"""AdamW with optax.adamw's state semantics (count, mu, nu), updating the
parameters and moments in place (isdf_tpu/models/fused_adamw.py):

    m <- b1 m + (1-b1) g          mhat = m / (1 - b1^t)
    v <- b2 v + (1-b2) g^2        vhat = v / (1 - b2^t)
    p <- p - lr_scale * lr * (mhat / (sqrt(vhat) + eps) + wd p)

``lr_scale`` folds in the refinement-tail decay: scaling the whole update
by s equals adamw(lr * s) at that step. The bias corrections are computed
on the host in float32 from the step count.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def init_state(params: Dict[str, torch.Tensor]):
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def make_fused_adamw(lr: float, weight_decay: float, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8):
    """Returns apply(params, grads, state, lr_scale) -> (params, state),
    both updated in place."""

    def apply(params, grads, state, lr_scale=1.0):
        count = state["count"] + 1
        t = np.float32(count)
        c1 = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b1) ** t))
        c2 = float(np.float32(1.0) / (np.float32(1.0) - np.float32(b2) ** t))
        step = float(np.float32(lr_scale) * np.float32(lr))
        for k, p in params.items():
            g, m, v = grads[k], state["mu"][k], state["nu"][k]
            m.mul_(b1).add_(g, alpha=1.0 - b1)
            v.mul_(b2).add_((1.0 - b2) * g * g)
            u = (m * c1) / (torch.sqrt(v * c2) + eps) + weight_decay * p
            p.sub_(step * u)
        state["count"] = count
        return params, state

    return apply
