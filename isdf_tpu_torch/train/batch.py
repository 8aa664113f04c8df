"""Batch experiment runner (isdf_tpu/train/batch.py; reference
isdf/train/batch_train/).

Matches batch_utils.py:204-436 and jobs_local.py:49-66 of the reference:
  * config generators: N seeded runs of each sequence of the benchmark
    list, one-parameter sweeps, set-params overrides;
  * a sequential runner writing one directory per run (``<seq>_<i>``, as
    exp0 names them) holding config.json, res.json and vox_res.json, which
    the figure tooling (eval/figs.py) reads directly.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# the paper's 12 benchmark sequences (reference eval/figs/all_seq.py:29-48)
REPLICACAD_SEQS = ["apt_2_nav", "apt_2_obj", "apt_2_mnp",
                   "apt_3_nav", "apt_3_obj", "apt_3_mnp"]
SCANNET_SEQS = ["scene0010_00", "scene0030_00", "scene0031_00",
                "scene0004_00", "scene0005_00", "scene0009_00"]


def set_params(cfg: Dict, overrides: Dict[str, object]) -> Dict:
    """Apply {'section.key': value} overrides to a raw config dict
    (reference batch_utils set-all-params generator)."""
    out = copy.deepcopy(cfg)
    for path, val in overrides.items():
        d = out
        keys = path.split(".")
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = val
    return out


def nruns_per_seq(base_cfg: Dict, seq_dirs: Sequence[str], n_runs: int,
                  gt_sdf_dirs: Optional[Sequence[str]] = None,
                  ) -> List[Tuple[Dict, str]]:
    """N seeded repeats of every sequence -> [(config, run_name)]
    (reference batch_utils.py:246-306)."""
    jobs = []
    for si, seq_dir in enumerate(seq_dirs):
        seq = [x for x in seq_dir.split("/") if x][-1]
        for run in range(n_runs):
            cfg = copy.deepcopy(base_cfg)
            cfg.setdefault("dataset", {})["seq_dir"] = seq_dir
            if gt_sdf_dirs is not None:
                cfg["dataset"]["gt_sdf_dir"] = gt_sdf_dirs[si]
            cfg["seed"] = run
            jobs.append((cfg, f"{seq}_{run}"))
    return jobs


def vary_param(base_cfg: Dict, param_path: str, values: Iterable,
               seq_dirs: Sequence[str], n_runs: int = 1,
               ) -> List[Tuple[Dict, str]]:
    """One-parameter ablation sweep (reference batch_utils.py:309-380)."""
    jobs = []
    pname = param_path.split(".")[-1]
    for v in values:
        for cfg, name in nruns_per_seq(base_cfg, seq_dirs, n_runs):
            jobs.append((set_params(cfg, {param_path: v}),
                         f"{pname}_{v}_{name}"))
    return jobs


def run(config: Dict, save_path: str, max_steps: Optional[int] = None,
        seed: Optional[int] = None, grid_dim: int = 200, device=None):
    """Run one experiment to its end, writing its result files (reference
    batch_utils.run, batch_utils.py:204-243). On the CUDA device unless
    ``device`` says otherwise."""
    from isdf_tpu_torch.engine import loop as LOOP
    from isdf_tpu_torch.engine.trainer import Trainer
    from isdf_tpu_torch.utils.config import config_from_dict

    os.makedirs(save_path, exist_ok=True)
    # a rerun, or a retry after a failure, must not leave an earlier
    # attempt's files behind: readers take "the last eval", which would be
    # stale
    for f in ("res.json", "vox_res.json"):
        p = os.path.join(save_path, f)
        if os.path.exists(p):
            os.remove(p)
    with open(os.path.join(save_path, "config.json"), "w") as f:
        json.dump(config, f, indent=4)

    cfg = config_from_dict(config)
    trainer = Trainer(cfg, grid_dim=grid_dim,
                      seed=seed if seed is not None
                      else int(config.get("seed", 1)), device=device)
    return LOOP.train_loop(trainer, max_steps=max_steps,
                           save_path=save_path,
                           log_fn=lambda m: print(m, flush=True))


def run_jobs(jobs: List[Tuple[Dict, str]], save_root: str,
             max_steps: Optional[int] = None, retries: int = 1,
             device=None):
    """Sequential runner (reference jobs_local.py:49-66). Returns {run
    name: LoopResult}, None for a job whose every attempt failed.

    retries: a failed job runs again from scratch up to this many times;
    a failed attempt's run directory is overwritten, so its partial
    res.json never enters a comparison."""
    os.makedirs(save_root, exist_ok=True)
    results = {}
    for cfg, name in jobs:
        out_dir = os.path.join(save_root, name)
        results[name] = None
        for attempt in range(1 + max(retries, 0)):
            tag = f" (retry {attempt})" if attempt else ""
            print(f"=== batch job {name}{tag} ===", flush=True)
            try:
                results[name] = run(cfg, out_dir, max_steps=max_steps,
                                    device=device)
                break
            except Exception as e:  # a failed run must not stop the batch
                print(f"job {name} failed: {e!r}", flush=True)
    return results
