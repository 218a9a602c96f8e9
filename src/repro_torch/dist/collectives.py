"""Tree-mean collectives -- the "send m_i to master, average" line of
Algorithm 1.  This slice ports ``dense_mean``, the exact worker mean of
the stacked-worker step.  The shared-pattern Rand-K mean and the q8 ring
all-reduce over ``torch.distributed`` come with ROADMAP queue 1, item 5.
"""

from __future__ import annotations

from typing import Dict

import torch


def dense_mean(wtree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Exact mean over the leading worker axis, leaf-wise."""
    return {k: a.mean(dim=0) for k, a in wtree.items()}
