"""The numbers that decide ``correct``: the program's first steps against the reference's.

Set-up drives the program's training step from the seed through its first
``FIRST_STEPS`` steps, each one call of the window's own ``step.many(1)``;
the reference trains the same steps from the same weights, inputs and
dropout masks.  Three numbers are compared, each with its limit from the
cell's ``workloads/<cell>.json``:

* ``loss``: the relative gap between the two sides' first-step losses.
  The later steps' losses are printed (``readings:``) and not compared:
  after one update the loss falls 10-260x, so it amplifies the last bits
  of that update (two runs of the reference differ by up to 1.2e-4 at step
  2; the port's capturable Adam takes its bias correction in f32, steps
  6.4e-6 shorter), see ``PERF.md``;
* ``grad``: the first gradient, as Adam got it (its state after step 1),
  by the worst leaf: the gap between the two sides' norms of a leaf, over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger;
* ``change``: the parameters' change over the steps, the same way, over
  the leaves whose reference gradient is at least ``MOVING`` of the median
  leaf's (a leaf whose gradient is nought to rounding moves under Adam by
  round-off alone), and within a leaf over the elements whose reference
  gradient is at least ``MOVING`` of the leaf's median element's, for the
  same reason: Adam's first update moves every element by about the
  learning rate whatever its gradient's size, so an element whose gradient
  is nought to rounding moves one way on one side and the other way on the
  other, and one such element moves a leaf's change by up to 1e-3.

A number that is not finite fails.
"""

from __future__ import annotations

import math
import statistics

FIRST_STEPS = 3
MOVING = 1e-3
NAMES = ("loss", "grad", "change")


def _leaf_gap(prog: dict, ref: dict, leaves) -> float:
    scale = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], scale) for k in leaves)


def moving_elements(ref) -> dict:
    """Each leaf's elements whose reference gradient is at least ``MOVING``
    of the leaf's median element's."""
    out = {}
    for k, g in ref.grad.items():
        a = g.abs()
        out[k] = a >= MOVING * a.flatten().median()
    return out


def norms(readings, moving: dict) -> dict:
    """The losses, each leaf's first-gradient norm and each leaf's change
    norm over its ``moving`` elements."""
    return {"losses": list(readings.losses),
            "grad": {k: float(g.norm()) for k, g in readings.grad.items()},
            "change": {k: float(d[moving[k]].norm()) for k, d in readings.change.items()}}


def gaps(prog, ref) -> dict:
    """``loss``, ``grad`` and ``change`` of the program's readings against
    the reference's (``reference.Readings`` both)."""
    moving = moving_elements(ref)
    p, r = norms(prog, moving), norms(ref, moving)
    loss = abs(p["losses"][0] - r["losses"][0]) / abs(r["losses"][0])
    leaves = sorted(r["grad"])
    median_grad = statistics.median(r["grad"][k] for k in leaves)
    kept = [k for k in leaves if r["grad"][k] >= MOVING * median_grad]
    return {"loss": loss, "grad": _leaf_gap(p["grad"], r["grad"], leaves),
            "change": _leaf_gap(p["change"], r["change"], kept)}


def passes(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit
