"""The kNN graphs a forward of the port built, recorded for the check.

DynEdge builds a kNN graph on each conv's output and the next conv reads
it.  Where two pulses lie at nearly the same distance, the last bits of
the latents decide which one is a neighbour, and the port's kernels and
the reference round differently: their graphs differ at such near ties,
and the answers with them.  So the reference follows the graphs the port
built, and the check holds that stage by itself: each recorded graph must
be exactly the k nearest neighbours of the coordinates the port passed in,
by the reference's arithmetic (``knn_mismatch``, limit 0).

The recorder is a ``TorchDispatchMode`` that sees every call of the port's
``knn_graph`` and ``edgeconv_knn_fwd`` operators while it is on.  It is on
only outside the window: over a training cell's check steps in set-up, and
over a re-run of each checked request after the window, whose answers
must equal the window's bit for bit (``rerun_gap``, limit 0).
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

KNN = "graphnet_tpu_torch::knn_graph"
FUSED = "graphnet_tpu_torch::edgeconv_knn_fwd"


class GraphRecorder(TorchDispatchMode):
    """Records ``{"coords", "mask", "k", "idx", "edge_mask"}`` of each kNN
    graph the port builds, in call order."""

    def __init__(self):
        super().__init__()
        self.calls: List[Dict[str, torch.Tensor]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.name() if hasattr(func, "name") else str(func)
        base = name.split(".", 1)[0]
        if base == KNN:
            coords, mask, k = args[0], args[1], int(args[2])
            idx, em = out
        elif base == FUSED:
            lo, hi, k = int(args[10]), int(args[11]), int(args[9])
            coords, mask = out[0][..., lo:hi], args[4]
            idx, em = out[1], out[2]
        else:
            return out
        self.calls.append({"coords": coords.detach().float().clone(),
                           "mask": mask.clone(), "k": k,
                           "idx": idx.clone(), "edge_mask": em.clone()})
        return out


def knn_mismatch(calls: List[Dict], knn) -> int:
    """Valid neighbour slots where a recorded graph differs from ``knn``
    (the reference's) on the same coordinates, plus slots valid on one
    side only."""
    bad = 0
    for c in calls:
        idx, em = knn(c["coords"], c["mask"], c["k"])
        em_p = c["edge_mask"]
        bad += int((em != em_p).sum())
        both = em & em_p
        bad += int(((idx.long() != c["idx"].long()) & both).sum())
    return bad
