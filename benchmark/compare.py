"""The numbers that decide ``correct``: the program's outputs against the
reference's, each reduced to one number that a limit in the workload file
bounds.

- ``code_gap``: over the checked rows, the widest gap by which the score
  ``0.5·‖e‖² − x·e`` of the program's code lies above the row's best, both
  from the reference's features and codebook, in float64. Exact codes give
  0, a near tie a rounding's worth, a wrong code about the spacing of the
  codebook.
- ``loss_gap``: the widest relative gap of a checked step's loss.
- ``leaf_gaps``: for each leaf, the gap between the program's and the
  reference's norm of it (a gradient, or a change of the weights), over
  the reference's norm of that leaf or of the median leaf, whichever is
  larger; a cell compares the widest.
"""

from __future__ import annotations

import statistics

import torch


@torch.no_grad()
def code_gap(feats: torch.Tensor, codebook: torch.Tensor, codes: torch.Tensor, block: int = 2048) -> float:
    x, e = feats.double(), codebook.double().to(feats.device)
    half = 0.5 * torch.sum(e * e, dim=1)
    codes = codes.reshape(-1).to(feats.device).long()
    if codes.numel() != x.shape[0]:
        return float("inf")
    if codes.numel() and (int(codes.min()) < 0 or int(codes.max()) >= e.shape[0]):
        return float("inf")
    worst = 0.0
    for i in range(0, x.shape[0], block):
        s = half[None] - x[i:i + block] @ e.T
        got = s.gather(1, codes[i:i + block, None])[:, 0]
        worst = max(worst, float((got - s.min(dim=1).values).max()))
    return worst


def loss_gap(program: list, reference: list) -> float:
    if len(program) != len(reference):
        return float("inf")
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def moved(ref_grad_norms: dict, share: float = 1e-3) -> list:
    """Leaves whose reference gradient is at least ``share`` of the median
    leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(ref_grad_norms.values())
    return [n for n, v in ref_grad_norms.items() if v >= share * med]


def leaf_gaps(program: dict, reference: dict, names=None) -> dict:
    """Each leaf's gap (infinite where the program lacks the leaf)."""
    names = list(reference) if names is None else list(names)
    med = statistics.median(reference[n] for n in names)
    return {n: abs(program[n] - reference[n]) / max(reference[n], med) if n in program else float("inf")
            for n in names}


def worst(gaps: dict, n: int = 3) -> str:
    """The ``n`` widest gaps, for the run's standard error."""
    return ", ".join(f"{k} {v:.3g}" for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:n])
