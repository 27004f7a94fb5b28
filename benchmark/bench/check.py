"""The comparison that decides `correct`: the answers the window kept
against the plain reference (`reference.operator`), worked out again from
the configuration and the run's seed, on the device in float64, as the
traffic's kind answers (``kinds/<kind>.py``).

A cell compares the numbers its limits file names, each the worst over
the answers kept: the relative L2 gap ‖a − r‖ / ‖r‖ (``*_rel_l2``) and the
largest absolute gap over the reference's largest magnitude, max |a − r| /
max |r| (``*_max_abs``).
"""

from __future__ import annotations

import torch

from .spec import BENCH, kind


def reference_answer(config: dict, traffic: dict, x, device, bench_dir=BENCH):
    """What every kept answer of this cell should be, from the float64
    reference: the `reference` of the traffic's kind (``kinds/<kind>.py``)
    on the run's unknown `x`."""
    return kind(traffic["kind"], bench_dir).reference(config, traffic, torch.as_tensor(x), device)


def gaps(answer, ref) -> dict:
    a = torch.as_tensor(answer).to(ref.device, torch.float64)
    r = ref.to(torch.float64)
    d = a - r
    return {"rel_l2": float(d.norm() / r.norm()), "max_abs": float(d.abs().max() / r.abs().max())}


def compare(answers: list, ref, limits: dict) -> dict:
    """{name: {"value", "limit"}} for each number the cell's limits name
    (``<x|g>_rel_l2``, ``<x|g>_max_abs``): the worst over the kept answers
    (index, tensor); a run that kept none reads infinite."""
    each = [gaps(a, ref) for _, a in answers]
    out = {}
    for name, limit in limits.items():
        kind = name.split("_", 1)[1]
        out[name] = {"value": max((g[kind] for g in each), default=float("inf")), "limit": float(limit)}
    return out


def passed(numbers: dict) -> bool:
    return all(n["value"] <= n["limit"] for n in numbers.values())
