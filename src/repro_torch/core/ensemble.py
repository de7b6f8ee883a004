"""Asymptotic ensemble learning framework (paper Sec. 9, Algorithm 2).

Base models are trained on RSP data blocks drawn by block-level sampling and
folded into an ensemble that is re-evaluated after every batch; the loop stops
when the evaluation metric plateaus or blocks run out.

All ``g`` base models of a batch are trained at once, as in the reference
package's ``jax.vmap``: every learner works on parameters with a leading
model axis (``bmm`` over the stacked blocks ``[g, n, F]``), and one
``torch.autograd.grad`` of the *sum* of the per-model losses gives each model
its own gradient, since no model's loss depends on another's parameters.
Training runs on the blocks' device.

Initial weights are drawn from an explicit ``torch.Generator`` on the host
and then moved to the blocks' device, so a run on the card starts from the
same weights as the same run on the CPU.  :func:`params_from_numpy` carries
stacked parameters across from another implementation (a dict of numpy
arrays with a leading model axis, such as the reference package's).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.sampler import BlockSampler
from repro_torch.device import resolve_device

Params = dict


def params_from_numpy(params: dict, device: str | torch.device) -> Params:
    """Stacked parameters (name -> array with a leading model axis) as
    float32 tensors on ``device``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(v, np.float32)).to(dev) for k, v in params.items()}


def _stack(params: list[Params]) -> Params:
    return {k: torch.stack([p[k] for p in params]) for k in params[0]}


def _on(params: Params, device: torch.device) -> Params:
    return {k: v.to(device=device, dtype=torch.float32) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Base learners (plain PyTorch; no sklearn)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BaseLearner:
    """init/fit/predict over a leading model axis.

    ``init(generator, f, c)`` draws one model's parameters on the host;
    ``fit_stacked(params, xs, ys)`` trains ``g`` models on stacked blocks
    ``[g, n, F]`` / ``[g, n]``; ``proba_stacked(params, x)`` gives each
    model's class probabilities ``[g, N, C]`` for one shared ``x [N, F]``.
    :meth:`fit` and :meth:`predict_proba` are the one-model forms."""

    name: str
    init: Callable[..., Params]
    fit_stacked: Callable[[Params, torch.Tensor, torch.Tensor], Params]
    proba_stacked: Callable[[Params, torch.Tensor], torch.Tensor]

    def fit(self, params: Params, x: torch.Tensor, y: torch.Tensor) -> Params:
        """Train one model on one block ``x [n, F]`` / ``y [n]``, on its device."""
        p = {k: v[None] for k, v in _on(params, x.device).items()}
        return {k: v[0] for k, v in self.fit_stacked(p, x[None], y[None]).items()}

    def predict_proba(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        p = {k: v[None] for k, v in _on(params, x.device).items()}
        return self.proba_stacked(p, x)[0]


def _gd_train(loss_fn, params: Params, steps: int, lr: float, momentum: float | None = None):
    """Full-batch gradient descent of every model at once: ``loss_fn``
    returns the per-model losses ``[g]``; their sum's gradient is each
    model's own.  With ``momentum``, ``m = momentum * m + grad`` and
    ``p -= lr * m``."""
    names = list(params)
    p = [params[k].detach().clone().requires_grad_(True) for k in names]
    mom = [torch.zeros_like(w) for w in p] if momentum is not None else None
    for _ in range(steps):
        grads = torch.autograd.grad(loss_fn(dict(zip(names, p))).sum(), p)
        with torch.no_grad():
            for i, (w, gw) in enumerate(zip(p, grads)):
                if mom is not None:
                    mom[i].mul_(momentum).add_(gw)
                    gw = mom[i]
                w.sub_(lr * gw)
    return {k: w.detach() for k, w in zip(names, p)}


def _xent(logits: torch.Tensor, y1h: torch.Tensor) -> torch.Tensor:
    """Per-model mean cross entropy ``[g]`` of logits ``[g, n, C]``."""
    return -(y1h * F.log_softmax(logits, dim=-1)).sum(-1).mean(-1)


def _one_hot(ys: torch.Tensor, num_classes: int) -> torch.Tensor:
    return F.one_hot(ys.to(torch.int64), num_classes).to(torch.float32)


def make_logreg(num_features: int, num_classes: int, *, steps: int = 300, lr: float = 0.5) -> BaseLearner:
    """Multinomial logistic regression trained with full-batch GD."""

    def init(gen: torch.Generator, f: int = num_features, c: int = num_classes) -> Params:
        return {
            "w": 0.01 * torch.randn((f, c), generator=gen, dtype=torch.float32),
            "b": torch.zeros((c,), dtype=torch.float32),
        }

    def fit_stacked(params: Params, xs: torch.Tensor, ys: torch.Tensor) -> Params:
        xs = xs.to(torch.float32)
        y1h = _one_hot(ys, num_classes)

        def loss(p):
            logits = torch.baddbmm(p["b"][:, None, :], xs, p["w"])
            return _xent(logits, y1h) + 1e-4 * (p["w"] ** 2).sum((1, 2))

        return _gd_train(loss, params, steps, lr)

    def proba_stacked(params: Params, x: torch.Tensor) -> torch.Tensor:
        logits = torch.einsum("nf,gfc->gnc", x.to(torch.float32), params["w"])
        return torch.softmax(logits + params["b"][:, None, :], dim=-1)

    return BaseLearner("logreg", init, fit_stacked, proba_stacked)


def make_mlp(
    num_features: int,
    num_classes: int,
    *,
    hidden: int = 32,
    steps: int = 400,
    lr: float = 0.05,
) -> BaseLearner:
    """One-hidden-layer MLP trained with full-batch GD + momentum."""

    def init(gen: torch.Generator, f: int = num_features, c: int = num_classes) -> Params:
        w1 = torch.randn((f, hidden), generator=gen, dtype=torch.float32) * (2.0 / f) ** 0.5
        w2 = torch.randn((hidden, c), generator=gen, dtype=torch.float32) * (2.0 / hidden) ** 0.5
        return {
            "w1": w1,
            "b1": torch.zeros((hidden,), dtype=torch.float32),
            "w2": w2,
            "b2": torch.zeros((c,), dtype=torch.float32),
        }

    def fit_stacked(params: Params, xs: torch.Tensor, ys: torch.Tensor) -> Params:
        xs = xs.to(torch.float32)
        y1h = _one_hot(ys, num_classes)

        def loss(p):
            h = torch.relu(torch.baddbmm(p["b1"][:, None, :], xs, p["w1"]))
            return _xent(torch.baddbmm(p["b2"][:, None, :], h, p["w2"]), y1h)

        return _gd_train(loss, params, steps, lr, momentum=0.9)

    def proba_stacked(params: Params, x: torch.Tensor) -> torch.Tensor:
        h = torch.einsum("nf,gfh->gnh", x.to(torch.float32), params["w1"])
        h = torch.relu(h + params["b1"][:, None, :])
        return torch.softmax(torch.baddbmm(params["b2"][:, None, :], h, params["w2"]), dim=-1)

    return BaseLearner("mlp", init, fit_stacked, proba_stacked)


# ---------------------------------------------------------------------------
# Batched training of one block-level sample
# ---------------------------------------------------------------------------

def train_base_models_vmapped(
    learner: BaseLearner, generator: torch.Generator, xs: torch.Tensor, ys: torch.Tensor
) -> Params:
    """Train g base models simultaneously on stacked blocks [g, n, F]/[g, n]
    (the name is the reference package's: its batch is a ``jax.vmap``).
    Each model's initial weights are the next draw of ``generator``."""
    init = _stack([learner.init(generator) for _ in range(xs.shape[0])])
    return learner.fit_stacked(_on(init, xs.device), xs, ys)


# ---------------------------------------------------------------------------
# Ensemble container + Algorithm 2 loop
# ---------------------------------------------------------------------------

def _accuracy(proba: torch.Tensor, y: torch.Tensor) -> float:
    """Share of rows whose argmax class is ``y``: the exact count over the
    row count (the reference's float32 mean may differ by one rounding)."""
    pred = torch.argmax(proba, dim=-1)
    return int((pred == y.to(pred.device)).sum()) / max(int(y.numel()), 1)


class Ensemble:
    """A bag of base models with probability-averaging combination."""

    def __init__(self, learner: BaseLearner):
        self.learner = learner
        self._stacked: Params | None = None  # leading model axis
        self.num_models = 0

    @property
    def params(self) -> Params:
        """The stacked parameters of every model so far (leading model axis)."""
        if self._stacked is None:
            raise ValueError("empty ensemble")
        return self._stacked

    def add_stacked(self, params: Params, count: int) -> None:
        if self._stacked is None:
            self._stacked = dict(params)
        else:
            self._stacked = {k: torch.cat([v, params[k]]) for k, v in self._stacked.items()}
        self.num_models += count

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        """Mean of the models' class probabilities ``[N, C]``, on the
        models' device."""
        params = self.params
        device = next(iter(params.values())).device
        return self.learner.proba_stacked(params, x.to(device)).mean(dim=0)

    def accuracy(self, x: torch.Tensor, y: torch.Tensor) -> float:
        return _accuracy(self.predict_proba(x), y)


@dataclasses.dataclass
class EnsembleHistory:
    blocks_used: list[int] = dataclasses.field(default_factory=list)
    accuracy: list[float] = dataclasses.field(default_factory=list)


def asymptotic_ensemble_learn(
    blocks_x: torch.Tensor | None = None,
    blocks_y: torch.Tensor | None = None,
    *,
    learner: BaseLearner,
    eval_x: torch.Tensor,
    eval_y: torch.Tensor,
    g: int,
    seed: int = 0,
    improvement_tol: float = 1e-3,
    patience: int = 2,
    max_batches: int | None = None,
    num_blocks: int | None = None,
    fetch_blocks: Callable[[list[int]], tuple[torch.Tensor, torch.Tensor]] | None = None,
) -> tuple[Ensemble, EnsembleHistory]:
    """Algorithm 2: batches of g blocks -> batched base models -> ensemble
    update -> evaluation; stop on plateau or block exhaustion.

    Either pass stacked in-memory blocks (``blocks_x``: [K, n, F],
    ``blocks_y``: [K, n]) or a lazy source (``fetch_blocks(ids) ->
    (xs, ys)`` with ``num_blocks``) so each batch loads only its sampled
    blocks -- the paper's touch-only-the-sample property for stored RSPs.
    Models train where the blocks lie; initial weights come from a host
    generator seeded with ``seed``.
    """
    if fetch_blocks is None:
        if blocks_x is None or blocks_y is None:
            raise ValueError("need blocks_x/blocks_y or fetch_blocks + num_blocks")
        K = blocks_x.shape[0]

        def fetch_blocks(ids: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
            idx = torch.as_tensor(ids, device=blocks_x.device)
            return blocks_x[idx], blocks_y[idx.to(blocks_y.device)]

    else:
        if num_blocks is None:
            raise ValueError("fetch_blocks needs num_blocks")
        K = num_blocks
    sampler = BlockSampler(K, seed=seed)
    ensemble = Ensemble(learner)
    history = EnsembleHistory()
    gen = torch.Generator().manual_seed(seed)
    stall = 0
    batch_idx = 0
    while sampler.remaining_in_epoch() > 0:
        if max_batches is not None and batch_idx >= max_batches:
            break
        ids = sampler.sample(min(g, sampler.remaining_in_epoch()))
        bx, by = fetch_blocks(ids)
        params = train_base_models_vmapped(learner, gen, bx, by)
        ensemble.add_stacked(params, len(ids))
        acc = ensemble.accuracy(eval_x, eval_y)
        history.blocks_used.append(ensemble.num_models)
        history.accuracy.append(acc)
        if len(history.accuracy) > 1:
            if acc - max(history.accuracy[:-1]) < improvement_tol:
                stall += 1
            else:
                stall = 0
            if stall >= patience:
                break
        batch_idx += 1
    return ensemble, history


def ensemble_vs_single_model(
    blocks_x: torch.Tensor,
    blocks_y: torch.Tensor,
    eval_x: torch.Tensor,
    eval_y: torch.Tensor,
    *,
    learner: BaseLearner,
    seed: int = 0,
) -> tuple[float, float]:
    """Fig-6 comparison: (ensemble accuracy, single-full-data-model accuracy)."""
    ens, _ = asymptotic_ensemble_learn(
        blocks_x,
        blocks_y,
        learner=learner,
        eval_x=eval_x,
        eval_y=eval_y,
        g=min(5, blocks_x.shape[0]),
        seed=seed,
    )
    full_x = blocks_x.reshape(-1, blocks_x.shape[-1])
    full_y = blocks_y.reshape(-1)
    params = learner.fit(learner.init(torch.Generator().manual_seed(seed + 1)), full_x, full_y)
    single_acc = _accuracy(learner.predict_proba(params, eval_x), eval_y)
    return ens.accuracy(eval_x, eval_y), single_acc
