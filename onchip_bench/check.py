"""How ``correct`` is decided: the program's first training steps against the
float32 reference's on the same weights and batches.

Four numbers, each held to its limit in ``limits/<cell>.json`` (a limit of
null: the number is printed and not held in that cell, ``PERF.md`` says why):

* ``first_loss_gap``: |loss - reference's| / |reference's| of the first step
  (the later steps' losses are printed beside it, not held: see ``PERF.md``);
* ``grad_norm_gap``: over the leaves, the largest gap between the norm of the
  first step's gradient as the optimizer takes it (after the clip) and the
  reference's, over the larger of the reference's norm of that leaf and the
  median leaf's;
* ``grad_dist``: over the leaves, the largest root mean square of the
  difference between the two first gradients at the leaf's sampled elements
  (``plain.sample_indices``), over the larger of the reference's root mean
  square there and the median leaf's.  Norms hide rounding that is unbiased;
  this distance does not;
* ``update_norm_gap``: the same of each leaf's norm of change over the steps,
  over the leaves whose reference gradient is at least ``GRAD_FLOOR`` of the
  median leaf's (a leaf whose gradient is nought to rounding moves by
  round-off alone).
"""

from __future__ import annotations

import statistics

NUMBERS = ("first_loss_gap", "grad_norm_gap", "grad_dist", "update_norm_gap")
GRAD_FLOOR = 1e-3


def _leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers (and the leaves that set the last two) of the
    program's readings ``prog`` against the reference's ``ref``."""
    if sorted(prog["grad_norms"]) != sorted(ref["grad_norms"]):
        raise ValueError("the program's and the reference's parameters differ")
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    grad = _leaf_gaps(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    med = statistics.median(ref["grad_norms"].values())
    moved = [k for k, g in ref["grad_norms"].items() if g >= GRAD_FLOOR * med]
    upd = _leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    rms = lambda t: float(t.float().pow(2).mean().sqrt())
    ref_rms = {k: rms(v) for k, v in ref["grad_samples"].items()}
    med_rms = statistics.median(ref_rms.values())
    dist = {k: rms(prog["grad_samples"][k] - v) / max(ref_rms[k], med_rms, 1e-30)
            for k, v in ref["grad_samples"].items()}
    grad_leaf, upd_leaf = max(grad, key=grad.get), max(upd, key=upd.get)
    dist_leaf = max(dist, key=dist.get)
    return {"first_loss_gap": losses[0], "grad_norm_gap": grad[grad_leaf],
            "grad_dist": dist[dist_leaf], "grad_dist_leaf": dist_leaf,
            "grad_dist_leaves": dict(sorted(dist.items(), key=lambda kv: -kv[1])[:4]),
            "update_norm_gap": upd[upd_leaf], "grad_norm_leaf": grad_leaf,
            "update_norm_leaf": upd_leaf, "loss_gaps": losses,
            "left_out": sorted(set(ref["grad_norms"]) - set(moved))}


def judge(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct where every number
    with a limit is finite and within it."""
    checks = {n: {"value": found[n], "limit": limits[n]} for n in NUMBERS}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in checks.values() if c["limit"] is not None)
    return ok, checks
