"""The port's serving path against the JAX package: prefill and KV-cache
decode logits, the cache layout, and ``serve`` end to end on the CPU.

The JAX model's params (JAX-initialized, cast to bf16) reach the port
through numpy (``repro_torch.convert``).  Logits within 0.06, the bound of
``tests/test_models_consistency.py``: the JAX jnp ``attend`` rounds the
scaled q and the softmax weights to bf16, the flash-attention function the
port serves with keeps them in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import _pad_cache_to
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint.serial import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.convert import state_from_numpy
from repro_torch.launch.serve import serve
from repro_torch.models import build_model

torch.set_num_threads(1)

ARCHS = ["yi-9b", "llama3.2-3b"]  # untied and tied embeddings
LOGIT_TOL = 0.06
T, B, N_DECODE = 32, 2, 5


def _pair(arch):
    jm = jax_build_model(jax_get_config(arch, reduced=True))
    pm = build_model(get_config(arch, reduced=True))
    params = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)),
                          jm.init(jax.random.key(0)))
    return jm, pm, params


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_track_jax(arch):
    """Prefill, then 5 decode steps teacher-forced on JAX's greedy tokens:
    every step's logits within 0.06 of the JAX model's."""
    jm, pm, params = _pair(arch)
    jp = jax.tree.map(jnp.asarray, params)
    pp = state_from_numpy(params, "cpu")
    toks = np.random.RandomState(0).randint(
        0, jm.cfg.vocab_size, (B, T)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    jc = _pad_cache_to(jc, jm, B, T + N_DECODE)
    pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)},
                        cache_len=T + N_DECODE)
    assert pl.dtype == torch.float32 and tuple(pl.shape) == jl.shape
    assert _err(pl.numpy(), jl) < LOGIT_TOL
    for name in ("k", "v"):   # the prompt's k/v, then the zero tail
        assert _err(pc["blocks"][name].float().numpy(),
                    jnp.asarray(jc["blocks"][name], jnp.float32)) < 0.05
    decode = jax.jit(jm.decode_step)
    for i in range(N_DECODE):
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = decode(jp, jc, {"tokens": jnp.asarray(tok[:, None]),
                                 "pos": jnp.int32(T + i)})
        pl, pc = pm.decode_step(pp, pc, {"tokens": torch.from_numpy(
            tok[:, None]), "pos": T + i})
        assert _err(pl.numpy(), jl) < LOGIT_TOL, i


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill_of_the_longer_prompt(arch):
    """One decode step against the prefilled cache equals the last logits
    of prefilling the extended prompt (the JAX package's consistency
    check, on the port)."""
    _, pm, params = _pair(arch)
    pp = state_from_numpy(params, "cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, pm.cfg.vocab_size, (B, T + 1)).astype(np.int32))
    _, cache = pm.prefill(pp, {"tokens": toks[:, :T]}, cache_len=T + 1)
    ld, _ = pm.decode_step(pp, cache, {"tokens": toks[:, T:], "pos": T})
    lf, _ = pm.prefill(pp, {"tokens": toks})
    assert _err(ld.numpy(), lf.numpy()) < LOGIT_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_spec_matches_jax(arch):
    jm, pm, _ = _pair(arch)
    jspec = jm.cache_spec(B, 48)
    pspec = pm.cache_spec(B, 48)
    for name in ("k", "v"):
        assert pspec["blocks"][name].shape == jspec["blocks"][name].shape
        assert pspec["blocks"][name].dtype == torch.bfloat16
        assert jspec["blocks"][name].dtype == jnp.bfloat16
    cache = pm.init_cache(B, 48, torch.device("cpu"))
    assert cache["blocks"]["k"].shape == pspec["blocks"]["k"].shape
    assert not cache["blocks"]["k"].any()


def test_decode_writes_the_cache_in_place():
    _, pm, params = _pair("yi-9b")
    pp = state_from_numpy(params, "cpu")
    toks = torch.zeros((B, 4), dtype=torch.int32)
    _, cache = pm.prefill(pp, {"tokens": toks}, cache_len=6)
    k = cache["blocks"]["k"]
    assert not k[:, :, 4:].any()
    _, out = pm.decode_step(pp, cache, {"tokens": toks[:, :1], "pos": 4})
    assert out["blocks"]["k"] is k
    assert k[:, :, 4].any() and not k[:, :, 5].any()


def test_bf16_init_is_the_float32_init_rounded():
    """The server's layer-by-layer bf16 weights equal bf16(float32 init)."""
    pm = build_model(get_config("yi-9b", reduced=True))
    cpu = torch.device("cpu")
    f32 = pm.init(3, cpu)
    bf = pm.init(3, cpu, dtype=torch.bfloat16)
    for (p, a), (_, b) in zip(
            flatten_with_paths(f32), flatten_with_paths(bf)):
        assert b.dtype == torch.bfloat16, p
        assert torch.equal(a.to(torch.bfloat16), b), p


JAX_SERVE_KEYS = {"arch", "batch", "prompt_len", "new_tokens",
                  "prefill_seconds", "decode_seconds", "decode_tokens_per_s",
                  "sample_tokens", "tokens_digest", "served_step", "restore",
                  "swap", "cache"}


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_on_the_cpu_end_to_end(arch):
    kw = dict(arch=arch, batch=2, prompt_len=16, new_tokens=4, seed=0,
              device="cpu", num_layers=2)
    r1 = serve(**kw)
    r2 = serve(**kw)
    assert set(r1) == JAX_SERVE_KEYS
    assert r1["tokens_digest"] == r2["tokens_digest"]
    assert len(r1["tokens_digest"]) == 32
    assert len(r1["sample_tokens"]) == 4
    assert all(0 <= t < get_config(arch, reduced=True).vocab_size
               for t in r1["sample_tokens"])
    assert r1["cache"] is None and r1["served_step"] is None
    assert r1["decode_tokens_per_s"] > 0


def test_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(arch="yi-9b", batch=1, prompt_len=4, new_tokens=1)
