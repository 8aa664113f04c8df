"""Traffic kind ``fleet``: K robots' maps sharing one card.

Set-up builds K trainers, scene i over the room of seed + i with a full
arena, joins them in a ``MultiSceneStepper`` and drives their first three
steps through it; the window then calls ``MultiSceneStepper.run_steps(
bundle)`` back to back: each round steps every scene ``bundle`` times and
bills every scene's clock the whole round.
"""

from __future__ import annotations

from benchmark import trainers as TR
from benchmark import window


def _setup(ctx, cfg):
    from isdf_tpu_torch.parallel.multi_scene import MultiSceneStepper

    K = int(ctx.params["scenes"])
    scenes = [TR.build(ctx, ctx.seed + i, cfg) for i in range(K)]
    stepper = MultiSceneStepper([s.trainer for s in scenes])

    def losses(n):
        return [r["total_loss"].tolist() for r in stepper.run_steps(n)]

    firsts = TR.first_steps(losses, [s.trainer for s in scenes],
                            TR.REF.Map(cfg))
    prog = {"call": (stepper, "run_steps"),
            "wrap": [(stepper, "run_steps", "bench.run_steps")]}
    return scenes, firsts, prog


def run(ctx):
    cfg = ctx.config()
    return window.train_window(ctx, cfg, *_setup(ctx, cfg))
