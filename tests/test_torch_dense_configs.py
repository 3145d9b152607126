"""The port's config registry against the JAX package's, and the two
plain dense GQA configs of ROADMAP A5 (glm4-9b, phi3-medium-14b), which
need nothing but their config: every ported config equals the JAX one
field for field (full and reduced), and each new dense config's reduced
model gives the JAX model's logits and loss (within 0.02 and 2e-3, the
bounds of ``tests/test_torch_model.py``) and the same checkpoint store,
byte for byte.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.saver import CheckpointManager as JaxManager
from repro.configs import get_config as jax_get_config
from repro.core import LayerRegistry as JaxRegistry
from repro.core.policies import make_policy as jax_make_policy
from repro.data.synthetic import SyntheticTokens
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch.checkpoint.saver import CheckpointManager
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import state_from_numpy
from repro_torch.core.layer_registry import LayerRegistry
from repro_torch.core.policies import make_policy
from repro_torch.models import build_model

torch.set_num_threads(1)

DENSE = ["glm4-9b", "phi3-medium-14b"]
BB = 4096


def _pair(arch):
    jm = jax_build_model(jax_get_config(arch, reduced=True))
    pm = build_model(get_config(arch, reduced=True))
    st = jax.tree.map(np.asarray, jax_steps.init_state(jm,
                                                       jax.random.key(0)))
    return jm, pm, st


def test_registry_holds_the_ported_archs():
    assert ARCH_IDS == ["yi-9b", "llama3.2-3b", "mamba2-370m", "zamba2-2.7b",
                        "glm4-9b", "phi3-medium-14b", "deepseek-v2-lite-16b",
                        "arctic-480b"]


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_the_jax_package_field_for_field(arch, reduced):
    """Every field; ``source`` (a citation, no shape) only for the configs
    ported since A5 (the port's llama3.2-3b cites the 3B model card where
    the JAX package's names the 1B one)."""
    port = dataclasses.asdict(get_config(arch, reduced=reduced))
    jax_cfg = jax_get_config(arch, reduced=reduced).model_dump()
    if arch not in DENSE + ["zamba2-2.7b", "deepseek-v2-lite-16b",
                            "arctic-480b"]:
        port.pop("source"), jax_cfg.pop("source")
    assert port == jax_cfg


@pytest.mark.parametrize("arch", DENSE)
def test_reduced_logits_and_loss_match_jax(arch):
    jm, pm, st = _pair(arch)
    batch = SyntheticTokens(vocab_size=512, batch=2, seq_len=64,
                            seed=1).peek(0)
    params = jax.tree.map(jnp.asarray, st["params"])
    h, pos = jm._embed(params, batch)
    h, _ = jm._backbone_train(params, h, pos)
    jlogits = np.asarray(jm._logits(params, h))
    jloss = float(jm.loss(params, batch)[0])
    pst = state_from_numpy(st, "cpu")
    tokens = torch.from_numpy(batch["tokens"])
    with torch.no_grad():
        plogits = pm.logits(pst["params"], tokens).numpy()
        ploss = float(pm.loss(pst["params"], {"tokens": tokens})[0])
    np.testing.assert_allclose(plogits, jlogits, rtol=0, atol=0.02)
    assert abs(ploss - jloss) < 2e-3


@pytest.mark.parametrize("arch", DENSE)
def test_same_state_same_store(tmp_path, arch):
    """The initial state and a perturbed one (two elements of block_001's
    query projection) saved by both packages: equal manifests and
    byte-identical objects."""
    jm, pm, st = _pair(arch)
    s1 = jax.tree.map(np.array, st)
    for tree in (s1["params"], s1["opt"]["master"]):
        w = tree["blocks"]["attn"]["wq"][1]
        w.flat[:2] = (w.flat[:2].astype(np.float32) + 0.5).astype(w.dtype)
    jmgr = JaxManager(tmp_path / "jax", JaxRegistry(jm),
                      jax_make_policy("full", jm.layer_units()),
                      codec="none", async_save=False, fp_block_bytes=BB)
    pmgr = CheckpointManager(tmp_path / "port", LayerRegistry(pm),
                             make_policy("full", pm.layer_units()),
                             async_save=False, fp_block_bytes=BB)
    try:
        for step, s in ((1, st), (2, s1)):
            jmgr.save(s, step=step)
            pmgr.save(state_from_numpy(s, "cpu"), step=step)
            jm_ = jmgr.manifests.load(step)
            pm_ = pmgr.manifests.load(step)
            assert {u: {k: (r.digest, r.stored, r.delta_base)
                        for k, r in kinds.items()}
                    for u, kinds in pm_.entries.items()} == \
                {u: {k: (r.digest, r.stored, r.delta_base)
                     for k, r in kinds.items()}
                 for u, kinds in jm_.entries.items()}
    finally:
        jmgr.close()
        pmgr.close()
    objs = {r: {p.name: p.read_bytes() for p in sorted(
        (tmp_path / r / "objects").glob("*/*.chunk"))}
        for r in ("jax", "port")}
    assert objs["port"] == objs["jax"] and objs["port"]
