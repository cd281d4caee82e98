"""The comparison that decides ``correct``: what the timed path produced
against the plain reference (``reference/<family>.py``), run once the
window has closed on the same seeded weights and the same raw events,
which the reference pads itself.

Training: the program's first three steps (set-up drives the trainer
through them, through the window's own call and feed) against three
reference steps on the same events and a plain Adam:

* ``loss_gap``: the largest relative gap of a step's loss, and
  ``loss1_gap`` the first step's;
* ``grad_gap``: over the leaves, the largest gap between the norms of the
  first gradient as the optimizer got it (its first moment after one step
  over ``1 - beta1``) and the reference's, over the larger of the
  reference leaf's norm and the median leaf's;
* ``update_gap``: the same of the parameters' change over the three
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (moved by round-off alone),
  ``update_gap_median`` the median leaf's, and ``update1_gap`` that of
  the change of the first step alone;
* ``adam_gap``: the optimizer alone, over the three steps.  A plain Adam
  (:class:`FollowAdam`) takes the program's own gradient of each step
  from the same seeded weights; over the same kept leaves, the largest
  norm of the difference between the program's parameters after the
  three steps and the plain Adam's, over the larger of the leaf's plain
  change and the median leaf's.  It follows the program, so the rounding
  that later steps amplify between program and reference does not enter
  it; a leaf that the program left without a gradient reads 1.

Reprocessing: the answers of requests drawn from the seed among those the
window answered, row by row: a row's gap is the largest over its columns
of the gap to the reference over the family's scale of that answer
(``reference/<family>.py``'s ``answer_scale``: its magnitude for an
energy, 1 for a unit vector's component); ``row_gap`` is the largest
row's and ``row_gap_median`` the median row's.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

BETAS = (0.9, 0.999)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero), as the tensor cores read a TF32 product's inputs."""
    bits = (x.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


class _Tf32Products(TorchFunctionMode):
    """The control's products on a device without TF32 (the CPU): every
    matrix product's fp32 inputs rounded to TF32, the sums in fp32."""

    PRODUCTS = ("matmul", "__matmul__", "mm", "bmm", "linear", "einsum")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.PRODUCTS:
            keep = 2 if name == "linear" else len(args)
            args = tuple(round_tf32(a) if i < keep and isinstance(a, torch.Tensor)
                         and a.dtype == torch.float32 else a
                         for i, a in enumerate(args))
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 matrix products on (the control) or off (the reference): on a
    card the backends' switches, on the CPU :class:`_Tf32Products`."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    mode = (_Tf32Products() if on and not torch.cuda.is_available()
            else contextlib.nullcontext())
    try:
        with mode:
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def collate(events, idx: Sequence[int], device):
    """The reference's own padding of events ``idx``: ``(x [B, L, D],
    mask, n, labels)`` with L the longest event's length."""
    idx = np.asarray(idx)
    n = events.n[idx]
    L = int(n.max())
    x = np.zeros((len(idx), L, events.x.shape[1]), np.float32)
    for r, i in enumerate(idx):
        x[r, :n[r]] = events.event(int(i))
    mask = np.arange(L)[None, :] < n[:, None]
    labels = {k: torch.from_numpy(v[idx]).to(device)
              for k, v in events.labels.items()}
    return (torch.from_numpy(x).to(device), torch.from_numpy(mask).to(device),
            torch.from_numpy(n.astype(np.int32)).to(device), labels)


def reference_steps(ref, model_cfg: Dict, weights: Dict[str, torch.Tensor],
                    events, batches: List[Sequence[int]], lr: float,
                    eps: float, device, control: bool = False,
                    half_batch: bool = False, graphs=None, record=None) -> Dict:
    """Three (or ``len(batches)``) reference training steps: each step's
    loss, the first gradient's leaf norms and the change's leaf norms.
    ``control`` runs it in TF32; ``half_batch`` takes the loss over the
    first half of each batch (a fault the check must catch).  ``graphs``:
    a step's kNN graphs as another side built them, to follow
    (``harness/capture.py``); ``record``: a list that gets this side's."""
    params = {k: v.detach().clone().requires_grad_() for k, v in weights.items()}
    model = ref.Model(model_cfg, params)
    names = list(params)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    s = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first, change1 = [], None, None
    for t, idx in enumerate(batches, 1):
        x, mask, n, labels = collate(events, idx, device)
        rows = slice(0, len(idx) // 2) if half_batch else slice(None)
        with tf32(control):
            pred = model.forward(x, mask, n, **_graph_args(
                ref, graphs[t - 1] if graphs else None, record))
            loss = model.loss(pred, labels, rows)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: float(g.norm()) for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                adam_update(params[k], m[k], s[k], g, t, lr, eps)
        if change1 is None:
            change1 = {k: float((params[k].detach() - weights[k]).norm())
                       for k in names}
    change = {k: float((params[k].detach() - weights[k]).norm()) for k in names}
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "change1_norms": change1}


def adam_update(p, m, s, g, t: int, lr: float, eps: float) -> None:
    """Adam's step ``t`` (from 1) of one leaf in place, torch's formula:
    ``p -= lr / c1 * m / (sqrt(s) / sqrt(c2) + eps)``."""
    c1, c2 = 1 - BETAS[0] ** t, 1 - BETAS[1] ** t
    m.mul_(BETAS[0]).add_(g, alpha=1 - BETAS[0])
    s.mul_(BETAS[1]).addcmul_(g, g, value=1 - BETAS[1])
    p.addcdiv_(m, (s.sqrt() / c2 ** 0.5).add_(eps), value=-lr / c1)


class FollowAdam:
    """A plain Adam that follows the program: it starts from the program's
    parameters before its first step and takes, each step, the gradients
    the program's optimizer took (a leaf's own step count, as torch's Adam
    skips a leaf without a gradient)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, eps: float):
        self.lr, self.eps = lr, eps
        self.p = {k: v.detach().clone() for k, v in params.items()}
        self.start = {k: v.clone() for k, v in self.p.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.s = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = dict.fromkeys(self.p, 0)
        self.steps = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        self.steps += 1
        for k, g in grads.items():
            if g is not None:
                self.t[k] += 1
                adam_update(self.p[k], self.m[k], self.s[k], g.detach(),
                            self.t[k], self.lr, self.eps)

    @torch.no_grad()
    def gaps(self, params: Dict[str, torch.Tensor]) -> Dict:
        """``adam_gaps``: each leaf's norm of the program's parameters less
        the plain Adam's, over the larger of the leaf's plain change and
        the median leaf's; ``adam_missing``: the leaves that had no
        gradient in some step."""
        plain = {k: float((self.p[k] - self.start[k]).norm()) for k in self.p}
        median = float(np.median(list(plain.values())))
        gaps = {k: float((params[k].detach() - self.p[k]).norm())
                / max(plain[k], median, 1e-30) for k in self.p}
        return {"adam_gaps": gaps, "adam_missing":
                sorted(k for k, t in self.t.items() if t < self.steps)}


def _graph_args(ref, graphs, record) -> Dict:
    """The keyword arguments of a forward that follows ``graphs`` and
    records its own into ``record`` (a list that gets one list a forward),
    for a family whose reference builds graphs."""
    if not getattr(ref.Model, "follows_graphs", False):
        return {}
    if record is not None:
        record.append([])
    return {"graphs": graphs, "record": None if record is None else record[-1]}


def program_first_gradient(trainer, names: Dict[int, str]) -> Dict[str, float]:
    """Leaf norms of the gradient the optimizer took in its first step,
    from its first moment (``(1 - beta1) g`` after one step)."""
    out = {name: 0.0 for name in names.values()}
    if trainer.optimizer is None:
        return out
    for group in trainer.optimizer.param_groups:
        beta1 = group["betas"][0]
        for p in group["params"]:
            m = trainer.optimizer.state.get(p, {}).get("exp_avg")
            if m is not None:
                out[names[id(p)]] = float(m.norm()) / (1 - beta1)
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=lambda k: True) -> Dict[str, float]:
    """Each kept leaf's gap of norms over the larger of its reference norm
    and the median leaf's."""
    median = float(np.median(list(ref.values())))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30)
            for k in ref if keep(k)}


def compare_train(prog: Dict, ref: Dict) -> Dict[str, float]:
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(prog["losses"], ref["losses"])]
    g_ref = ref["grad_norms"]
    floor = 1e-3 * float(np.median(list(g_ref.values())))
    grads = leaf_gaps(prog["grad_norms"], g_ref)
    moved = lambda k: g_ref[k] >= floor  # noqa: E731
    changes = leaf_gaps(prog["change_norms"], ref["change_norms"], moved)
    changes1 = leaf_gaps(prog["change1_norms"], ref["change1_norms"], moved)
    out = {
        "loss_gap": max(losses),
        "loss1_gap": losses[0],
        "grad_gap": max(grads.values()),
        "update_gap": max(changes.values()),
        "update_gap_median": float(np.median(list(changes.values()))),
        "update1_gap": max(changes1.values()),
    }
    if "adam_gaps" in prog:
        missing = set(prog["adam_missing"])
        out["adam_gap"] = max(1.0 if k in missing else v
                              for k, v in prog["adam_gaps"].items() if moved(k))
    return out


def reference_answers(ref, model_cfg: Dict, weights: Dict[str, torch.Tensor],
                      events, requests: List[Sequence[int]], device,
                      control: bool = False, graphs=None,
                      record=None) -> List[np.ndarray]:
    """The reference's answers to each request, request by request
    (``graphs``, ``record``: one entry a request, as in
    :func:`reference_steps`)."""
    model = ref.Model(model_cfg, weights)
    out = []
    with torch.no_grad(), tf32(control):
        for r, idx in enumerate(requests):
            x, mask, n, _ = collate(events, idx, device)
            pred = model.forward(x, mask, n, **_graph_args(
                ref, graphs[r] if graphs else None, record))
            out.append(model.answer(pred).float().cpu().numpy())
    return out


def row_gaps(prog: List[np.ndarray], ref: List[np.ndarray], scale) -> np.ndarray:
    """Each row's largest gap over its columns, ``inf`` where the shapes
    differ or a value is not finite."""
    p, r = np.concatenate(prog), np.concatenate(ref)
    if p.shape != r.shape:
        return np.full(len(r), np.inf)
    with np.errstate(invalid="ignore", divide="ignore"):
        gap = np.abs(p - r) / np.maximum(scale(r), 1e-30)
    return np.where(np.isfinite(gap), gap, np.inf).max(axis=1)


def compare_rows(prog: List[np.ndarray], ref: List[np.ndarray],
                 scale) -> Dict[str, float]:
    rows = row_gaps(prog, ref, scale)
    return {"row_gap": float(rows.max()), "row_gap_median": float(np.median(rows))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, {name: {"value", "limit"}})`` over the numbers that have
    a limit; with no limit at all nothing is compared and it is not
    correct.  A number that is not finite shows as 1e308, which JSON holds."""
    shown = {k: {"value": numbers[k] if np.isfinite(numbers[k]) else 1e308,
                 "limit": limits[k]}
             for k in limits if k in numbers}
    ok = bool(shown) and all(v["value"] <= v["limit"] for v in shown.values())
    missing = [k for k in limits if k not in numbers]
    return ok and not missing, shown
