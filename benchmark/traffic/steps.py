"""Traffic kind ``steps``: one trainer between camera frames.

Set-up fills the arena with every view of the room and drives the
trainer's first three steps (the comparison's readings); the window then
calls ``Trainer.run_steps(bundle)`` back to back, the call the online loop
makes for each frame, with nothing ingested between calls.
"""

from __future__ import annotations

from benchmark import trainers as TR
from benchmark import window


def _setup(ctx, cfg):
    scene = TR.build(ctx, ctx.seed, cfg)
    tr = scene.trainer

    def losses(n):
        return [tr.run_steps(n)["total_loss"].tolist()]

    firsts = TR.first_steps(losses, [tr], TR.REF.Map(cfg))
    prog = {"call": (tr, "run_steps"),
            "wrap": [(tr, "run_steps", "bench.run_steps")]}
    return [scene], firsts, prog


def run(ctx):
    cfg = ctx.config()
    return window.train_window(ctx, cfg, *_setup(ctx, cfg))
