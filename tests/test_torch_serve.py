"""The port's serving engine against the reference's, on the CPU at smoke
size: greedy ``Server.generate`` and the RSP block ensemble
(``EnsembleServer``, k = 2) must give the reference's tokens exactly, with
the reference's weights carried across as numpy arrays.  Temperature
sampling cannot give ``jax.random.categorical``'s bits, so it is held to
determinism per seed and to valid token ids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models.common import init_params as ref_init_params
from repro.serve.engine import EnsembleServer as RefEnsembleServer
from repro.serve.engine import Server as RefServer
from repro_torch import kernels
from repro_torch.configs import smoke_config
from repro_torch.models.transformer import DenseLM
from repro_torch.serve import EnsembleServer, ServeConfig, Server, ensemble_logprobs


def _params(arch, seed):
    rcfg = ref_smoke_config(arch)
    return rcfg, ref_init_params(ref_api.model_specs(rcfg), jax.random.PRNGKey(seed))


def _prompts(vocab, seed=9, shape=(3, 8)):
    return np.random.default_rng(seed).integers(0, vocab, shape, np.int32)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen2-0.5b", "qwen3-14b", "granite-20b"])
def test_greedy_generate_gives_the_reference_tokens(arch):
    rcfg, params = _params(arch, 0)
    prompts = _prompts(rcfg.vocab_size)
    want = RefServer(rcfg, params).generate(jnp.asarray(prompts), max_new_tokens=12)
    cfg = smoke_config(arch)
    server = Server(cfg, DenseLM(cfg, params=jax.tree.map(np.asarray, params), device="cpu"),
                    device="cpu")
    kernels.reset_launch_counts()
    got, logits = server.generate(prompts, max_new_tokens=12, return_logits=True)
    assert kernels.launch_counts()["flash_attention"] == 0
    assert got.dtype == np.int32 and got.shape == (3, 20)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert logits.shape == (3, 12, rcfg.vocab_size) and logits.dtype == torch.float32
    assert torch.equal(logits.argmax(-1), torch.from_numpy(got[:, 8:]).long())
    stats = server.last_stats
    assert stats["new_tokens"] == 12 and 0 < stats["prefill_s"] <= stats["first_token_s"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-20b"])
def test_ensemble_generate_gives_the_reference_tokens(arch):
    rcfg, p0 = _params(arch, 0)
    _, p1 = _params(arch, 1)
    prompts = _prompts(rcfg.vocab_size, seed=4)
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), p0, p1)
    want = RefEnsembleServer(rcfg, stacked).generate(jnp.asarray(prompts), max_new_tokens=10)
    cfg = smoke_config(arch)
    models = [DenseLM(cfg, params=jax.tree.map(np.asarray, p), device="cpu") for p in (p0, p1)]
    ens = EnsembleServer(cfg, models, device="cpu")
    assert ens.k == 2
    got = ens.generate(prompts, max_new_tokens=10)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_ensemble_of_one_is_the_single_model():
    cfg = smoke_config("qwen3-14b")
    model = DenseLM(cfg, device="cpu", seed=3)
    prompts = _prompts(cfg.vocab_size, seed=5)
    single = Server(cfg, model, device="cpu").generate(prompts, max_new_tokens=6)
    np.testing.assert_array_equal(
        EnsembleServer(cfg, [model], device="cpu").generate(prompts, max_new_tokens=6), single)
    l = torch.randn(2, 5, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(ensemble_logprobs([l]), torch.log_softmax(l, -1))
    torch.testing.assert_close(ensemble_logprobs([l, l, l]), torch.log_softmax(l, -1))


def test_temperature_sampling_is_deterministic_per_seed():
    cfg = smoke_config("llama3.2-1b")
    model = DenseLM(cfg, device="cpu", seed=0)
    prompts = _prompts(cfg.vocab_size, seed=7, shape=(4, 6))

    def run(seed):
        sc = ServeConfig(temperature=1.5, seed=seed)
        return Server(cfg, model, sc, device="cpu").generate(prompts, max_new_tokens=16)

    a, b, c = run(11), run(11), run(12)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    np.testing.assert_array_equal(a[:, :6], prompts)
    assert a.min() >= 0 and a.max() < cfg.vocab_size
    greedy = Server(cfg, model, device="cpu").generate(prompts, max_new_tokens=16)
    assert not np.array_equal(a, greedy)


def test_serve_launcher_runs_on_the_host(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "qwen2-0.5b", "--device", "cpu", "--new-tokens", "4", "--batch", "2"])
    serve.main(["--arch", "granite-20b", "--device", "cpu", "--new-tokens", "3", "--ensemble", "2"])
    out = capsys.readouterr().out
    assert "single qwen2-0.5b on cpu" in out and "ensemble[2] granite-20b on cpu" in out
    assert "tok/s" in out
