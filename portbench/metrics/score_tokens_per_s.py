"""score_tokens_per_s: every position scored in the window over the
window's seconds (host clock; the window ends at a synchronize after the
last call)."""

from portbench.metrics.train_tokens_per_s import read  # noqa: F401
