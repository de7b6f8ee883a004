"""Block-level sampling (Definition 4) and host-level block scheduling.

A *block level sample* draws ``g < K`` RSP blocks without replacement with
equal probability.  Because every block is a random sample of the corpus,
this replaces record-level sampling at zero scan cost.  The sampler is
deterministic given ``(seed, epoch, cursor)`` -- the entire data-pipeline
checkpoint is three integers (see core.types.SamplerState).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core.types import SamplerState


def _epoch_permutation(seed: int, epoch: int, num_blocks: int) -> np.ndarray:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xB10C, epoch]))
    return rng.permutation(num_blocks)


class BlockSampler:
    """Without-replacement block-level sampler over K RSP blocks.

    Within one epoch no block is repeated (paper Sec. 7: "without repeating a
    block neither in the same sample nor in other samples in the same analysis
    process").  Crossing an epoch boundary reshuffles with a fresh
    deterministic permutation.
    """

    def __init__(self, num_blocks: int, seed: int = 0, state: SamplerState | None = None):
        if num_blocks <= 0:
            raise ValueError("num_blocks must be positive")
        self.num_blocks = num_blocks
        self.state = state if state is not None else SamplerState(seed=seed)
        self._perm = _epoch_permutation(self.state.seed, self.state.epoch, num_blocks)

    # -- Definition 4 ------------------------------------------------------
    def sample(self, g: int) -> list[int]:
        """Draw the next ``g`` blocks without replacement (one batch)."""
        if g <= 0:
            raise ValueError("g must be positive")
        out: list[int] = []
        while len(out) < g:
            if self.state.cursor >= self.num_blocks:
                self._advance_epoch()
            take = min(g - len(out), self.num_blocks - self.state.cursor)
            out.extend(self._perm[self.state.cursor : self.state.cursor + take].tolist())
            self.state.cursor += take
        return out

    def remaining_in_epoch(self) -> int:
        return self.num_blocks - self.state.cursor

    def _advance_epoch(self) -> None:
        self.state.epoch += 1
        self.state.cursor = 0
        self._perm = _epoch_permutation(self.state.seed, self.state.epoch, self.num_blocks)

    # -- checkpointing -----------------------------------------------------
    def state_dict(self) -> dict[str, int]:
        return self.state.to_dict()

    @classmethod
    def from_state_dict(cls, num_blocks: int, d: dict[str, int]) -> "BlockSampler":
        return cls(num_blocks, state=SamplerState.from_dict(d))

    def batches(self, g: int, *, max_batches: int | None = None) -> Iterator[list[int]]:
        """Iterate block-level samples until the epoch's blocks are used up."""
        count = 0
        while self.remaining_in_epoch() > 0:
            if max_batches is not None and count >= max_batches:
                return
            yield self.sample(min(g, self.remaining_in_epoch()))
            count += 1


@dataclasses.dataclass
class HostAssignment:
    """Deal of block ids to hosts for one epoch (multi-host training)."""

    host_blocks: dict[int, list[int]]

    def blocks_for(self, host: int) -> list[int]:
        return self.host_blocks.get(host, [])

    def redistribute(self, failed_hosts: Sequence[int]) -> "HostAssignment":
        """Re-deal a failed host's blocks to the survivors (round-robin).

        Theorem 1 makes the re-dealt unions statistically valid: unions of
        RSP blocks in corpus proportion are RSP blocks of the union.
        """
        failed = set(failed_hosts)
        survivors = sorted(h for h in self.host_blocks if h not in failed)
        if not survivors:
            raise ValueError("no surviving hosts")
        orphaned: list[int] = []
        for h in sorted(failed):
            orphaned.extend(self.host_blocks.get(h, []))
        new = {h: list(self.host_blocks[h]) for h in survivors}
        for i, b in enumerate(orphaned):
            new[survivors[i % len(survivors)]].append(b)
        return HostAssignment(new)


def deal_blocks(
    num_blocks: int, num_hosts: int, seed: int = 0, epoch: int = 0
) -> HostAssignment:
    """Deterministically deal a fresh epoch permutation across hosts."""
    perm = _epoch_permutation(seed, epoch, num_blocks)
    return HostAssignment(
        {h: perm[h::num_hosts].tolist() for h in range(num_hosts)}
    )


# ---------------------------------------------------------------------------
# Sampling policies: sketch-guided block selection
# ---------------------------------------------------------------------------

class SamplingPolicy:
    """Strategy for choosing which blocks a block-level sample contains.

    ``uniform`` is the paper's Definition 4 (every block equally likely,
    without replacement).  The non-uniform policies use the partition-time
    sketches to *bias* selection toward informative blocks -- in the style of
    summary-statistics-driven partition selection (Rong et al., 2020) --
    and expose the Horvitz-Thompson ``weights`` that make downstream
    moment estimates unbiased again (``combine_summaries(..., weights=)``).

    Interface: ``sample(g) -> ids`` (stateful, deterministic from seed +
    draw counter), ``weights(ids)`` (HT weights for a draw, ``None`` when
    the plain average is already unbiased), ``epoch`` (a monotone tag for
    per-visit block permutations in the loader), and ``state_dict`` /
    ``load_state_dict`` for O(1) resume.
    """

    name = "base"

    def sample(self, g: int) -> list[int]:
        raise NotImplementedError

    def weights(self, ids: Sequence[int]) -> np.ndarray | None:
        return None

    @property
    def epoch(self) -> int:
        return 0

    def state_dict(self) -> dict:
        raise NotImplementedError

    def load_state_dict(self, state: dict) -> None:
        raise NotImplementedError

    def _fingerprint_payload(self) -> dict:
        raise NotImplementedError

    def fingerprint(self) -> str:
        """Digest of the selection *distribution* (not the draw counter).

        Two policies with equal fingerprints produce identical block-id
        sequences from identical draw counters.  Distributed hosts compare
        fingerprints before a query so a stale manifest / divergent summary
        set fails loudly instead of silently skewing HT weights.
        """
        payload = json.dumps(self._fingerprint_payload(), sort_keys=True)
        return hashlib.sha1(payload.encode()).hexdigest()


class UniformPolicy(SamplingPolicy):
    """Definition-4 sampling: equal probability, without replacement within
    an epoch (delegates to :class:`BlockSampler`)."""

    name = "uniform"

    def __init__(self, num_blocks: int, *, seed: int = 0):
        self.sampler = BlockSampler(num_blocks, seed=seed)

    def sample(self, g: int) -> list[int]:
        return self.sampler.sample(g)

    @property
    def epoch(self) -> int:
        return self.sampler.state.epoch

    def state_dict(self) -> dict:
        return {"kind": self.name, "sampler": self.sampler.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.sampler = BlockSampler.from_state_dict(
            self.sampler.num_blocks, state["sampler"]
        )

    def _fingerprint_payload(self) -> dict:
        return {
            "kind": self.name,
            "seed": int(self.sampler.state.seed),
            "num_blocks": int(self.sampler.num_blocks),
        }


def sketch_dispersion(summaries: Sequence) -> np.ndarray:
    """Per-block selection score from the partition-time sketches: the
    feature-averaged spread plus mean magnitude, ``mean_j(std_j + |mean_j|)``.

    For skewed corpora this tracks each block's contribution to the corpus
    totals (blocks with large/spread-out values score high), which is what
    probability-proportional-to-size selection wants.  Any positive score
    stays *unbiased* under HT reweighting; the score only moves variance.
    """
    return np.array(
        [float(np.mean(s.std + np.abs(s.mean))) for s in summaries], dtype=np.float64
    )


class WeightedPolicy(SamplingPolicy):
    """PPS selection: g independent draws with replacement, block ``k`` with
    probability proportional to its sketch dispersion.  ``weights`` returns
    the Hansen-Hurwitz / HT factors ``1 / (g * p_k)`` so that
    ``sum_k w_k * t_k`` is an unbiased estimate of the corpus total of any
    per-block total ``t_k``."""

    name = "weighted"

    def __init__(
        self,
        num_blocks: int,
        summaries: Sequence | None = None,
        *,
        probabilities: np.ndarray | None = None,
        seed: int = 0,
        floor: float = 0.05,
    ):
        if probabilities is None:
            if summaries is None:
                raise ValueError("weighted policy needs summaries or probabilities")
            score = sketch_dispersion(summaries)
            # floor keeps every block reachable (and HT weights bounded)
            score = score + floor * max(score.mean(), 1e-12)
            probabilities = score
        p = np.asarray(probabilities, dtype=np.float64)
        if p.shape != (num_blocks,) or np.any(p < 0) or p.sum() <= 0:
            raise ValueError("probabilities must be non-negative, one per block")
        self.probabilities = p / p.sum()
        self.seed = seed
        self._draws = 0

    def sample(self, g: int) -> list[int]:
        if g <= 0:
            raise ValueError("g must be positive")
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 0x5E1EC7, self._draws])
        )
        self._draws += 1
        return rng.choice(
            self.probabilities.shape[0], size=g, replace=True, p=self.probabilities
        ).tolist()

    def weights(self, ids: Sequence[int]) -> np.ndarray:
        p = self.probabilities[np.asarray(ids, dtype=np.int64)]
        return 1.0 / (len(ids) * p)

    @property
    def epoch(self) -> int:
        return self._draws

    def state_dict(self) -> dict:
        return {"kind": self.name, "seed": self.seed, "draws": self._draws}

    def load_state_dict(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self._draws = int(state["draws"])

    def _fingerprint_payload(self) -> dict:
        # exact float64 bytes: the PPS distribution IS the policy
        return {
            "kind": self.name,
            "seed": int(self.seed),
            "probabilities": hashlib.sha1(
                np.ascontiguousarray(self.probabilities).tobytes()
            ).hexdigest(),
        }


class StratifiedPolicy(SamplingPolicy):
    """Label-histogram stratification: blocks are grouped by their dominant
    label (argmax of the sketch's label histogram), draws are allocated to
    strata proportionally to stratum size (largest remainder), and blocks are
    drawn uniformly without replacement within each stratum.  ``weights``
    returns ``B_h / g_h`` (stratum size over draws taken from it), the HT
    expansion for stratified totals -- exactly unbiased once every stratum
    receives a draw; with ``g`` below the stratum count, strata are included
    randomly in proportion, so single-draw estimates cover a random subset
    of strata and are only approximately unbiased (use ``weighted`` when
    small-``g`` exactness matters)."""

    name = "stratified"

    def __init__(self, num_blocks: int, summaries: Sequence, *, seed: int = 0):
        if len(summaries) != num_blocks:
            raise ValueError("need one summary per block")
        if any(getattr(s, "label_hist", None) is None for s in summaries):
            raise ValueError("stratified policy needs label histograms in the sketches")
        strata: dict[int, list[int]] = {}
        for k, s in enumerate(summaries):
            strata.setdefault(int(np.argmax(s.label_hist)), []).append(k)
        self.strata = {h: np.asarray(ids) for h, ids in sorted(strata.items())}
        self._stratum_of = np.empty(num_blocks, dtype=np.int64)
        for h, ids in self.strata.items():
            self._stratum_of[ids] = h
        self.seed = seed
        self._draws = 0

    def _allocate(self, g: int, rng: np.random.Generator) -> dict[int, int]:
        """Proportional allocation of g draws to strata, capped at stratum
        size: integer parts are deterministic, the fractional remainder draws
        are assigned *randomly* with probability proportional to the
        remainders -- so even ``g=1`` streams (the loader's refill pattern)
        visit every stratum in corpus proportion instead of starving the
        small ones."""
        sizes = {h: len(ids) for h, ids in self.strata.items()}
        total = sum(sizes.values())
        g = min(g, total)
        exact = {h: g * b / total for h, b in sizes.items()}
        alloc = {h: min(int(e), sizes[h]) for h, e in exact.items()}
        short = g - sum(alloc.values())
        while short > 0:
            open_strata = [h for h in self.strata if alloc[h] < sizes[h]]
            rem = np.array(
                [max(exact[h] - int(exact[h]), 1e-9) for h in open_strata]
            )
            h = open_strata[int(rng.choice(len(open_strata), p=rem / rem.sum()))]
            alloc[h] += 1
            short -= 1
        return alloc

    def sample(self, g: int) -> list[int]:
        if g <= 0:
            raise ValueError("g must be positive")
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 0x57A7A, self._draws])
        )
        self._draws += 1
        out: list[int] = []
        for h, take in self._allocate(g, rng).items():
            if take > 0:
                ids = self.strata[h]
                out.extend(rng.choice(ids, size=take, replace=False).tolist())
        return out

    def weights(self, ids: Sequence[int]) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        strata = self._stratum_of[ids]
        drawn = {h: int((strata == h).sum()) for h in np.unique(strata)}
        return np.array(
            [len(self.strata[h]) / drawn[h] for h in strata], dtype=np.float64
        )

    @property
    def epoch(self) -> int:
        return self._draws

    def state_dict(self) -> dict:
        return {"kind": self.name, "seed": self.seed, "draws": self._draws}

    def load_state_dict(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self._draws = int(state["draws"])

    def _fingerprint_payload(self) -> dict:
        return {
            "kind": self.name,
            "seed": int(self.seed),
            "strata": {
                str(h): [int(b) for b in ids] for h, ids in self.strata.items()
            },
        }


class QueryAwarePolicy(WeightedPolicy):
    """PPS selection scored against the *specific aggregate being asked*
    (in the style of Rong et al., 2020) instead of dispersion alone.

    Per-block score = expected matching rows x target-feature dispersion x
    group coverage:

    * **predicate selectivity** -- each block's expected fraction of rows
      passing the query's conjunctive predicates, estimated from its
      per-column KLL quantile sketch (``SketchSuite.selectivity``; v1
      suites fall back to a uniform-over-[min, max] interpolation), scaled
      by the block's record count;
    * **target dispersion** -- ``std + |mean|`` of the aggregated feature
      only (all features averaged when the query has no single target),
      the same magnitude proxy :func:`sketch_dispersion` uses globally;
    * **group coverage** -- for grouped queries, the fraction of label
      classes the block's label histogram covers, so blocks that can renew
      every group's estimate are preferred.

    The same probability floor as :class:`WeightedPolicy` keeps every block
    reachable, so the Hansen-Hurwitz/HT ``weights`` stay bounded and the
    downstream estimates unbiased.  Selection only moves variance: blocks
    rich in predicate-passing, high-signal rows arrive first and the
    stopping rule fires after fewer reads.
    """

    name = "query_aware"

    def __init__(
        self,
        num_blocks: int,
        summaries: Sequence,
        *,
        predicates: Sequence = (),
        feature: int | None = None,
        by_label: bool = False,
        seed: int = 0,
        floor: float = 0.05,
    ):
        if summaries is None or len(summaries) != num_blocks:
            raise ValueError("query_aware policy needs one summary per block")
        score = self.score_blocks(
            summaries, predicates=predicates, feature=feature, by_label=by_label
        )
        score = score + floor * max(score.mean(), 1e-12)
        super().__init__(num_blocks, probabilities=score, seed=seed)

    @staticmethod
    def score_blocks(
        summaries: Sequence,
        *,
        predicates: Sequence = (),
        feature: int | None = None,
        by_label: bool = False,
    ) -> np.ndarray:
        score = np.empty(len(summaries), dtype=np.float64)
        for k, s in enumerate(summaries):
            sel = 1.0
            if predicates:
                sel = (
                    s.selectivity(predicates)
                    if hasattr(s, "selectivity")
                    else 1.0
                )
            if feature is not None:
                disp = float(s.std[feature] + np.abs(s.mean[feature]))
            else:
                disp = float(np.mean(s.std + np.abs(s.mean)))
            cover = 1.0
            if by_label:
                hist = getattr(s, "label_hist", None)
                if hist is not None and len(hist):
                    cover = float(np.count_nonzero(hist)) / len(hist)
            score[k] = s.count * sel * disp * cover
        return score


POLICIES = ("uniform", "weighted", "stratified", "query_aware")


def make_policy(
    policy: str | SamplingPolicy,
    num_blocks: int,
    *,
    seed: int = 0,
    summaries: Sequence | None = None,
    **kwargs,
) -> SamplingPolicy:
    """Resolve a policy name (or pass through an instance).

    ``"uniform"`` needs nothing beyond the block count; ``"weighted"`` and
    ``"stratified"`` need the per-block sketches (``RSPDataset.summaries``).
    """
    if isinstance(policy, SamplingPolicy):
        return policy
    if policy == "uniform":
        return UniformPolicy(num_blocks, seed=seed, **kwargs)
    if policy == "weighted":
        return WeightedPolicy(num_blocks, summaries, seed=seed, **kwargs)
    if policy == "stratified":
        if summaries is None:
            raise ValueError("stratified policy needs summaries")
        return StratifiedPolicy(num_blocks, summaries, seed=seed, **kwargs)
    if policy == "query_aware":
        if summaries is None:
            raise ValueError("query_aware policy needs summaries")
        return QueryAwarePolicy(num_blocks, summaries, seed=seed, **kwargs)
    raise ValueError(
        f"unknown sampling policy {policy!r}"
        " (uniform | weighted | stratified | query_aware)"
    )
