"""The legacy zoo's training half in the port vs the JAX package on the
CPU: the gradient of every zoo head's loss with respect to all its
parameters (the port's ``loss.backward()`` against ``jax.grad`` of the JAX
loss, in masked mode: each linear's gradient masked as its product), the
train-time image processors (RandAugment op by op and composed), and
``cli.train``'s refusal of a zoo arch, at tiny float32 widths
(parameters from JAX's init, perturbed and masked from a numpy seed,
crossed by the weight bridge).

Tolerances: each gradient leaf within 1e-4 × max(1, max |JAX leaf|); a
leaf JAX gives zeros (a parameter the loss does not reach) gets no
gradient or zeros in the port; processors bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_alpro import init_alpro, videos
from test_torch_gpt_dialogue import dialogue_batch, init_gpt
from test_torch_pnp_vqa import contexts, init_pnp
from test_torch_zoo_models import clip_ids, images, init_zoo, text
from vlm_compression_tpu.datasets import processors as JP
from vlm_compression_tpu_torch.cli import train as TT
from vlm_compression_tpu_torch.datasets import processors as TP
from vlm_compression_tpu_torch.models.bridge import flatten


def _batch(arch, rng):
    """The inputs of each arch's loss (masked-mode training batch)."""
    ids, mask = text(rng, 3, 6)
    lbl = ids.copy()
    lbl[1, -1] = -100
    if arch in ("blip_pretrain", "blip_caption"):
        return dict(image=images(rng, 3), input_ids=ids,
                    attention_mask=mask, labels=lbl)
    if arch in ("blip_retrieval", "albef_retrieval"):
        return dict(image=images(rng, 3), input_ids=ids,
                    attention_mask=mask)
    if arch == "blip_nlvr":
        return dict(image0=images(rng, 3), image1=images(rng, 3),
                    input_ids=ids, attention_mask=mask,
                    labels=np.array([0, 1, 1], np.int32))
    if arch == "albef_pretrain":
        mlm = ids.copy()
        mlm[:, 2] = 3
        mlm_lbl = np.full_like(mlm, -100)
        mlm_lbl[:, 2] = ids[:, 2]
        return dict(image=images(rng, 3), input_ids=ids, attention_mask=mask,
                    mlm_input_ids=mlm, mlm_labels=mlm_lbl)
    if arch == "clip":
        return dict(image=images(rng, 3), input_ids=clip_ids(rng))
    if arch == "alpro_retrieval":
        return dict(video=videos(rng, 3), input_ids=ids, attention_mask=mask)
    if arch == "alpro_qa":
        return dict(video=videos(rng, 3), input_ids=ids, attention_mask=mask,
                    labels=np.array([1, 0, 1], np.int32))
    if arch == "gpt_dialogue":
        return dialogue_batch(rng)
    if arch == "pnp_unifiedqav2_fid":
        c_ids, c_mask, labels = contexts(rng)
        return dict(ctx_ids=c_ids, ctx_mask=c_mask, labels=labels)
    ids, mask = text(rng, 2, 6, vocab=96)
    labels = rng.integers(1, 96, (2, 4)).astype(np.int32)
    labels[0, -1] = -100
    return dict(input_ids=ids, attention_mask=mask, labels=labels)


def _init(arch, seed):
    if arch.startswith("alpro_"):
        return init_alpro(arch, seed)
    if arch == "gpt_dialogue":
        return init_gpt(seed)
    if arch == "pnp_unifiedqav2_fid":
        return init_pnp(arch, seed)
    return init_zoo(arch, seed=seed)


LOSSES = ["blip_pretrain", "blip_caption", "blip_retrieval", "blip_nlvr",
          "albef_pretrain", "albef_retrieval", "clip", "alpro_retrieval",
          "alpro_qa", "gpt_dialogue", "pnp_unifiedqav2_fid", "t5"]


@pytest.mark.parametrize("arch", LOSSES)
def test_loss_gradients_match_jax(arch):
    """The gradient over ALL parameters, leaf by leaf; the gradient of the
    FiD reader and of the plain T5 includes T5's relative-position table
    (the attention backward's bias gradient)."""
    jm, variables, tm = _init(arch, 70 + LOSSES.index(arch))
    batch = _batch(arch, np.random.default_rng(LOSSES.index(arch)))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    masks = variables.get("masks", {})

    def loss(params):
        out = jm.apply({"params": params, "masks": masks}, **jbatch,
                       mode="masked")
        return out["loss"]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    out = tm(**{k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
             mode="masked")
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(jloss), rtol=1e-5,
                               atol=1e-5)
    want = {".".join(p): np.asarray(g) for p, g in flatten(jgrads).items()}
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    reached = 0
    for name, w in want.items():
        g = named[name].grad
        g = np.zeros_like(w) if g is None else g.numpy()
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)
        reached += bool(np.abs(w).max() > 0)
    assert reached >= len(want) // 2
    if arch in ("pnp_unifiedqav2_fid", "t5"):
        rel = [n for n in want if n.endswith("rel_embedding")]
        assert rel and all(np.abs(want[n]).max() > 0 for n in rel)


# ------------------------------------------------------------ RandAugment


def _pictures(seed):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 256, (48, 40, 3), dtype=np.uint8),
           (rng.integers(0, 256, (33, 57, 3)) // 50 * 40).astype(np.uint8),
           np.full((30, 30, 3), 7, np.uint8)]
    out[2][10:20, 5:9] = 200
    return out


@pytest.mark.parametrize("name", sorted(JP._RA_OPS))
def test_randaugment_ops_equal_pillow(name):
    """Each op at both signs of the magnitude the processor uses (0.5) and
    at the extremes (±1), on three pictures (random, banded, near flat)."""
    from PIL import Image

    assert sorted(TP._RA_OPS) == sorted(JP._RA_OPS)
    for arr in _pictures(1):
        for v in (-1.0, -0.5, 0.5, 1.0):
            want = np.asarray(JP._RA_OPS[name](Image.fromarray(arr), v))
            got = TP._RA_OPS[name](arr, v)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {v}")


@pytest.mark.parametrize("name,cfg", [
    ("blip_image_train", {"image_size": 32}),
    ("blip_image_train", {"image_size": 20, "min_scale": 0.8}),
    ("clip_image_train", {"image_size": 24})])
def test_train_processors_equal_jax(name, cfg):
    """The composed transforms from one seeded generator each: the crop,
    the flip and (BLIP-1) the two drawn ops and signs, bit for bit, and
    the generators kept in step."""
    from PIL import Image

    jp, tp = JP.load_processor(name, cfg), TP.load_processor(name, cfg)
    jp.rng, tp.rng = np.random.default_rng(5), np.random.default_rng(5)
    if name == "blip_image_train":
        jp.randaug.rng, tp.randaug.rng = jp.rng, tp.rng
    for _ in range(4):
        for arr in _pictures(2):
            want = jp(Image.fromarray(arr))
            got = tp(arr)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    assert jp.rng.random() == tp.rng.random()


def test_blip_image_train_defaults_match_jax():
    for name in ("blip_image_train", "clip_image_train"):
        jp, tp = JP.load_processor(name), TP.load_processor(name)
        assert (tp.image_size, tp.min_scale, tp.max_scale) == \
            (jp.image_size, jp.min_scale, jp.max_scale)
    assert TP.load_processor("blip_image_train").randaug.augs == \
        JP.load_processor("blip_image_train").randaug.augs


# ------------------------------------------------------------ no zoo trainer


def test_train_cli_refuses_a_zoo_arch(tmp_path):
    """The JAX CLI fails on a zoo config (it reads ``cfg.t5`` / ``.llm``,
    then ``.qformer``); the port's refuses before building, with the
    reason."""
    from pathlib import Path

    from vlm_compression_tpu.cli import train as JTr

    yaml_path = Path(__file__).resolve().parents[1] / \
        "configs/projects/blip/train/caption_coco_ft.yaml"
    opts = ["--options", "model.tiny=True",
            f"run.output_dir={tmp_path / 'out'}"]
    with pytest.raises(AttributeError, match="llm"):
        JTr.main(["--cfg-path", str(yaml_path), "--tiny", *opts])
    with pytest.raises(NotImplementedError, match="InstructBLIP"):
        TT.main(["--cfg-path", str(yaml_path), "--tiny", "--device", "cpu",
                 *opts])
