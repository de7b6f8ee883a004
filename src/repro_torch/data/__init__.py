from repro_torch.data.synthetic import (
    make_higgs_like,
    make_nonrandom_higgs_like,
    make_token_corpus,
)
from repro_torch.data.loader import BlockSource, PrefetchLoader, RSPLoader

__all__ = ["make_higgs_like", "make_nonrandom_higgs_like", "make_token_corpus", "BlockSource",
           "PrefetchLoader", "RSPLoader"]
