"""Head- and batch-sharded attention (``ops/attention.sharded_attention_core``,
the port's counterpart of the JAX package's ``_partitioned_fwd`` /
``_partitioned_bwd``) vs the JAX package's ``attention_core`` on the
whole arrays, on the CPU: T5's pattern — a (1, h, n, m) position bias
that broadcasts over the batch and a (b, 1, 1, m) pad bias that
broadcasts over the heads, as ``tests/test_ops_attention.py`` shards it —
in 4 gloo ranks at (data 2, model 2), (data 1, model 4) and
(data 4, model 1).  Each rank's output and q, k, v gradients are its block
of JAX's; both bias gradients are the whole (reduced) ones on every rank.
Tolerance: atol = rtol = 1e-5 (fp32, the same plain math on both sides,
summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parallel_ranks import train_rank
from vlm_compression_tpu.ops.attention import NEG_INF, attention_core
from vlm_compression_tpu_torch.parallel.collectives import spawn

MESHES = (dict(data=2, model=2), dict(data=1, model=4), dict(data=4, model=1))
TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(seed=24, b=4, n=16, h=4, d=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, h, d)).astype(np.float32) * 0.3
               for _ in range(3))
    relpos = (rng.standard_normal((1, h, n, n)) * 0.5).astype(np.float32)
    pad = np.where(rng.random((b, 1, 1, n)) < 0.2, NEG_INF,
                   0.0).astype(np.float32)
    g = rng.standard_normal((b, n, h, d)).astype(np.float32)
    return q, k, v, relpos, pad, g


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    q, k, v, relpos, pad, g = _inputs()
    cases = [("attention", (q, k, v, [relpos, pad], 1.0, mesh, g))
             for mesh in MESHES]
    ranks = spawn(train_rank, 4, "gloo",
                  str(tmp_path_factory.mktemp("attn") / "init"), 60.0,
                  args=(cases,))
    out, vjp = jax.vjp(lambda *a: attention_core(a[0], a[1], a[2],
                                                 [a[3], a[4]], scale=1.0),
                       *(jnp.asarray(x) for x in (q, k, v, relpos, pad)))
    grads = vjp(jnp.asarray(g))
    return ranks, np.asarray(out), [np.asarray(x) for x in grads]


def _block(x, mesh, rank):
    nb, nh = mesh["data"], mesh["model"]
    ib, ih = rank // nh, rank % nh
    b, h = x.shape[0] // nb, x.shape[2] // nh
    return x[ib * b:(ib + 1) * b, :, ih * h:(ih + 1) * h]


@pytest.mark.parametrize("case", range(len(MESHES)),
                         ids=[f"{m['data']}x{m['model']}" for m in MESHES])
def test_sharded_attention_values_and_qkv_grads_match_jax(sharded, case):
    ranks, out, (dq, dk, dv, _, _) = sharded
    for r, rank in enumerate(ranks):
        got = rank[case]
        np.testing.assert_allclose(got["out"], _block(out, MESHES[case], r),
                                   **TOL)
        for name, want in (("dq", dq), ("dk", dk), ("dv", dv)):
            np.testing.assert_allclose(got[name],
                                       _block(want, MESHES[case], r),
                                       err_msg=name, **TOL)


@pytest.mark.parametrize("case", range(len(MESHES)),
                         ids=[f"{m['data']}x{m['model']}" for m in MESHES])
def test_sharded_bias_grads_are_reduced_to_jax(sharded, case):
    """The position bias's gradient summed over data (it broadcasts over
    the batch), the pad bias's over model (over the heads); each gathered
    over the dims it is cut on."""
    ranks, _, (_, _, _, drel, dpad) = sharded
    assert np.abs(drel).max() > 0 and np.abs(dpad).max() > 0
    for rank in ranks:
        got_rel, got_pad = rank[case]["dbias"]
        np.testing.assert_allclose(got_rel, drel, **TOL)
        np.testing.assert_allclose(got_pad, dpad, **TOL)
