"""The PEFT tuners beside LoRA in the port vs the JAX package on the CPU:
prompt tuning (with and without an attention mask), prefix tuning (the
two-layer MLP over the prefix embeddings and the single product) and the
bottleneck adapter (each nonlinearity), their parameters from JAX's init
crossed by the weight bridge with strict keys.

Tolerance: every output within fp32 atol = rtol = 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import numpy_tree
from vlm_compression_tpu.compression import tuners as JT
from vlm_compression_tpu_torch.compression import tuners as TT
from vlm_compression_tpu_torch.models.bridge import load_jax_variables

TOL = dict(atol=1e-6, rtol=1e-6)


def _cross(jm, tm, *args, seed=0, **kw):
    variables = numpy_tree(dict(jm.init(jax.random.key(seed), *args, **kw)))
    load_jax_variables(tm, variables, strict=True)
    return variables


@pytest.mark.parametrize("with_mask", [True, False])
def test_prompt_tuning_matches_jax(with_mask):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    mask = np.ones((3, 5), np.int32) if with_mask else None
    cfg = dict(num_virtual_tokens=4, token_dim=16)
    jm = JT.PromptTuning(JT.PromptTuningConfig(**cfg))
    tm = TT.PromptTuning(TT.PromptTuningConfig(**cfg), device="cpu")
    jmask = None if mask is None else jnp.asarray(mask)
    variables = _cross(jm, tm, jnp.asarray(x), jmask, seed=1)
    want = jm.apply(variables, jnp.asarray(x), jmask)
    got = tm(torch.from_numpy(x),
             None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(want[0]),
                               **TOL)
    if with_mask:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].dtype == torch.int32
    else:
        assert got[1] is None and want[1] is None


@pytest.mark.parametrize("projection", [True, False])
def test_prefix_tuning_matches_jax(projection):
    cfg = dict(num_virtual_tokens=3, token_dim=16, num_layers=2,
               num_heads=4, encoder_hidden_size=8,
               prefix_projection=projection)
    jm = JT.PrefixTuning(JT.PrefixTuningConfig(**cfg))
    tm = TT.PrefixTuning(TT.PrefixTuningConfig(**cfg), device="cpu")
    variables = _cross(jm, tm, 2, seed=2)
    rng = np.random.default_rng(2)
    # biases off zero, so their layout is held too
    for layer in variables["params"].values():
        if "bias" in layer:
            layer["bias"] = rng.standard_normal(layer["bias"].shape).astype(
                np.float32)
    load_jax_variables(tm, variables, strict=True)
    want = np.asarray(jm.apply(variables, 5))
    got = tm(5).detach().numpy()
    assert got.shape == want.shape == (2, 2, 5, 3, 4, 4)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("act", ["relu", "gelu", "tanh"])
def test_bottleneck_adapter_matches_jax(act):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    cfg = dict(bottleneck_size=5, non_linearity=act, scaling=0.7)
    jm = JT.BottleneckAdapter(JT.BottleneckConfig(**cfg))
    tm = TT.BottleneckAdapter(TT.BottleneckConfig(**cfg), 12, device="cpu")
    variables = _cross(jm, tm, jnp.asarray(x), seed=3)
    variables["params"]["down"]["bias"] = rng.standard_normal(5).astype(
        np.float32)
    load_jax_variables(tm, variables, strict=True)
    np.testing.assert_allclose(
        tm(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jm.apply(variables, jnp.asarray(x))), **TOL)


def test_tuners_start_seeded_and_need_a_device_without_gpu(monkeypatch):
    a = TT.PromptTuning(TT.PromptTuningConfig(4, 8), device="cpu", seed=5)
    b = TT.PromptTuning(TT.PromptTuningConfig(4, 8), device="cpu", seed=5)
    assert torch.equal(a.prompt_embeddings, b.prompt_embeddings)
    assert float(a.prompt_embeddings.detach().std()) < 0.1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.BottleneckAdapter(TT.BottleneckConfig(), 8)
