from repro_torch.data.synthetic import make_higgs_like, make_nonrandom_higgs_like

__all__ = ["make_higgs_like", "make_nonrandom_higgs_like"]
