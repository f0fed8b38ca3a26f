"""The port's data layer vs Pillow and the JAX package on the CPU, every
comparison exact: ``_resample.resize_bicubic`` is bit-equal to Pillow's
BICUBIC resize (with and without a crop box, up and down, sizes 1-300);
each ported image processor gives JAX's float32 arrays bit for bit, from a
PNG and from the same image saved as ``.npy`` (``blip2_image_train`` from
generators of one seed); the builders, item datasets and ``DataLoader``
yield JAX's batches (keys, arrays bit-equal, values equal), in order,
shuffled, at world 2 and with a ragged tail; the loaders around them
(``IterLoader``, ``MultiIterLoader``, ``ConcatDataset``,
``reorg_datasets_by_split``, ``prepare_sample``, ``PrefetchLoader``).
"""

import json

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from vlm_compression_tpu.datasets import builders as JB
from vlm_compression_tpu.datasets import loaders as JL
from vlm_compression_tpu.datasets import processors as JP
from vlm_compression_tpu_torch.datasets import builders as TB
from vlm_compression_tpu_torch.datasets import items as TI
from vlm_compression_tpu_torch.datasets import loaders as TL
from vlm_compression_tpu_torch.datasets import processors as TP
from vlm_compression_tpu_torch.datasets._resample import resize_bicubic


def _image(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 300), w=st.integers(1, 300),
       oh=st.integers(1, 300), ow=st.integers(1, 300),
       seed=st.integers(0, 2 ** 31 - 1))
def test_resample_equals_pillow(h, w, oh, ow, seed):
    img = _image(np.random.default_rng(seed), h, w)
    want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BICUBIC))
    np.testing.assert_array_equal(resize_bicubic(img, (ow, oh)), want)


@settings(max_examples=60, deadline=None)
@given(h=st.integers(2, 300), w=st.integers(2, 300),
       oh=st.integers(1, 300), ow=st.integers(1, 300),
       box=st.tuples(*[st.floats(0, 1)] * 4),
       seed=st.integers(0, 2 ** 31 - 1))
def test_resample_with_a_box_equals_pillow(h, w, oh, ow, box, seed):
    img = _image(np.random.default_rng(seed), h, w)
    x0, y0 = box[0] * (w - 0.5), box[2] * (h - 0.5)
    b = (x0, y0, x0 + 0.5 + box[1] * (w - x0 - 0.5),
         y0 + 0.5 + box[3] * (h - y0 - 0.5))
    want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BICUBIC,
                                                  box=b))
    np.testing.assert_array_equal(resize_bicubic(img, (ow, oh), b), want)


@pytest.mark.parametrize("case", [
    ((256, 320), (224, 224), None), ((8, 5), (300, 1), None),
    ((40, 40), (40, 40), None), ((40, 40), (40, 40), (3, 2, 30, 33)),
    ((100, 30), (30, 100), (0.5, 0.25, 29.75, 99.5)), ((1, 1), (7, 3), None),
    ((300, 300), (1, 1), None), ((57, 91), (224, 224), (0, 0, 91, 57))],
    ids=str)
def test_resample_edge_cases_equal_pillow(case):
    (h, w), size, box = case
    img = _image(np.random.default_rng(h * w), h, w)
    want = np.asarray(Image.fromarray(img).resize(size, Image.BICUBIC,
                                                  box=box))
    np.testing.assert_array_equal(resize_bicubic(img, size, box), want)


@pytest.fixture(scope="module")
def pictures(tmp_path_factory):
    """Four RGB images (and one grey) as PNG and as .npy."""
    root = tmp_path_factory.mktemp("pictures")
    rng = np.random.default_rng(0)
    names = []
    for i, (h, w) in enumerate([(256, 320), (40, 30), (17, 240), (224, 224)]):
        img = _image(rng, h, w)
        Image.fromarray(img).save(root / f"p{i}.png")
        np.save(root / f"p{i}.npy", img)
        names.append(f"p{i}")
    grey = rng.integers(0, 256, (33, 47), dtype=np.uint8)
    Image.fromarray(grey).save(root / "grey.png")
    return root, names


PROCESSORS = [("blip_image_eval", {"image_size": 224}),
              ("blip_image_eval", {"image_size": 28}),
              ("blip2_image_train", {"image_size": 224}),
              ("blip2_image_train", {"image_size": 28, "min_scale": 0.9}),
              ("clip_image_eval", {"image_size": 224}),
              ("clip_image_eval", {"image_size": 20})]


@pytest.mark.parametrize("name,cfg", PROCESSORS,
                         ids=[f"{n}-{c['image_size']}" for n, c in PROCESSORS])
@pytest.mark.parametrize("ext", [".png", ".npy"])
def test_processor_equals_jax(pictures, name, cfg, ext):
    root, names = pictures
    jp = JP.load_processor(name, cfg)
    tp = TP.load_processor(name, cfg)
    if name == "blip2_image_train":
        jp.rng, tp.rng = (np.random.default_rng(5), np.random.default_rng(5))
    for n in names + (["grey"] if ext == ".png" else []):
        with Image.open(root / f"{n}.png") as img:
            want = jp(img)
        got = tp(TI.load_image(str(root / f"{n}{ext}")))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    if name == "blip2_image_train":          # the generators kept in step
        assert jp.rng.random() == tp.rng.random()


def test_unported_processors_raise_with_their_item():
    for name in ("blip_image_train", "clip_image_train", "alpro_video_eval"):
        with pytest.raises(NotImplementedError, match="item 11"):
            TP.load_processor(name, {})
    with pytest.raises(ValueError):
        TP.as_rgb(np.zeros((4, 4, 3), np.float32))


@pytest.fixture(scope="module")
def annotations(pictures):
    """Caption, VQA and retrieval annotation files over the pictures, in
    PNG (read by both packages) and .npy (the port only) versions."""
    root, names = pictures
    rng = np.random.default_rng(1)
    words = ["a", "dog", "on", "the", "red", "grass", "near", "tree"]
    caps, vqa, ret = [], [], []
    for i in range(10):
        n = names[i % len(names)]
        caption = " ".join(rng.choice(words, 2 + i % 5)) + "."
        caps.append({"image": n, "caption": [caption, "second"]
                     if i % 3 == 0 else caption, "image_id": 100 + i})
        answers = [str(a) for a in rng.choice(["yes", "no", "two"], 10)]
        vqa.append({"image": n, "question": f"What is {i}?",
                    "question_id": i, "answer": answers if i % 4
                    else answers[0]})
        ret.append({"image": n, "caption": [caption, f"{caption} too"]})
    out = {}
    for ext in (".png", ".npy"):
        for kind, anns in (("cap", caps), ("vqa", vqa), ("ret", ret)):
            anns = [dict(a, image=a["image"] + ext) for a in anns]
            path = root / f"{kind}{ext}.json"
            path.write_text(json.dumps(anns if kind != "ret"
                                       else {"annotations": anns}))
            out[kind, ext] = str(path)
    return root, out


def _cfg(root, ann, vis, text):
    return {"build_info": {"annotations": {"train": [ann], "val": ann,
                                           "test": [ann, ann]},
                           "images": {"storage": str(root)}},
            "vis_processor": {"train": {"name": vis, "image_size": 28},
                              "eval": {"name": "blip_image_eval",
                                       "image_size": 28}},
            "text_processor": {"train": {"name": text},
                               "eval": {"name": text}}}


BUILDERS = [("prefix_conceptual_caption_3m", "cap", "blip_image_eval",
             "blip_caption"),
            ("coco_caption", "cap", "blip_image_eval", "blip_caption"),
            ("coco_vqa", "vqa", "blip_image_eval", "blip_question"),
            ("gqa", "vqa", "blip_image_eval", "blip_question"),
            ("flickr30k", "ret", "blip_image_eval", "blip_caption")]


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("name,kind,vis,text", BUILDERS,
                         ids=[b[0] for b in BUILDERS])
@pytest.mark.parametrize("ext", [".png", ".npy"])
def test_builder_items_and_loader_equal_jax(annotations, name, kind, vis,
                                            text, ext):
    root, anns = annotations
    want = JB.load_builder(name, _cfg(root, anns[kind, ".png"], vis,
                                      text)).build_datasets(
        max_train_samples=7)
    got = TB.load_builder(name, _cfg(root, anns[kind, ext], vis,
                                     text)).build_datasets(
        max_train_samples=7)
    assert list(got) == list(want) == ["train", "val", "test"]
    for split in want:
        assert len(got[split]) == len(want[split])
        if name == "flickr30k":
            for attr in ("text", "txt2img", "img2txt"):
                assert getattr(got[split], attr) == getattr(want[split],
                                                            attr)
        for kw in (dict(batch_size=3), dict(batch_size=4, shuffle=True,
                                            seed=3),
                   dict(batch_size=2, shuffle=True, drop_last=True,
                        rank=1, world_size=2),
                   dict(batch_size=3, rank=0, world_size=2)):
            jl = JL.DataLoader(want[split], **kw)
            tl = TL.DataLoader(got[split], **kw)
            jl.set_epoch(1)
            tl.set_epoch(1)
            assert len(tl) == len(jl)
            np.testing.assert_array_equal(tl._indices(), jl._indices())
            jb, tb = list(jl), list(tl)
            assert len(tb) == len(jb)
            for g, w in zip(tb, jb):
                _assert_batches_equal(g, w)


def test_unported_builders_raise_with_their_item():
    for name, item in (("nlvr", "item 11"), ("msrvtt_qa", "item 11")):
        with pytest.raises(NotImplementedError, match=item):
            TB.load_builder(name, {})
    assert set(TB.registry.list_names("builder")) >= set(
        JB.registry.list_names("builder"))


def _numbers(n, offset=0):
    class DS:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"x": np.full((2,), offset + i, np.int64), "i": offset + i}

        def collater(self, items):
            return {"x": np.stack([s["x"] for s in items]),
                    "i": [s["i"] for s in items]}

    return DS()


def test_iteration_loaders_equal_jax():
    a, b = _numbers(5), _numbers(3, 100)
    jc, tc = JL.ConcatDataset([a, b]), TL.ConcatDataset([a, b])
    assert len(tc) == len(jc) == 8
    assert [tc[i]["i"] for i in range(8)] == [jc[i]["i"] for i in range(8)]
    for mk in (lambda L, d: L.IterLoader(L.DataLoader(d, 3, shuffle=True)),
               lambda L, d: L.MultiIterLoader(
                   [L.DataLoader(d, 2), L.DataLoader(b, 1)], [0.7, 0.3],
                   seed=4)):
        jit, tit = mk(JL, a), mk(TL, a)
        for _ in range(9):
            _assert_batches_equal(next(tit), next(jit))
    it = TL.IterLoader(TL.DataLoader(a, 2))
    [next(it) for _ in range(4)]
    assert it.epoch == 1
    nested = {"d1": {"train": 1, "val": 2}, "d2": {"train": 3}}
    assert TL.reorg_datasets_by_split(nested) == \
        JL.reorg_datasets_by_split(nested)


def test_prepare_sample_and_prefetch_on_the_cpu(monkeypatch):
    batch = {"x": np.arange(6, dtype=np.float32).reshape(2, 3),
             "ids": ["a", "b"], "obj": np.array([{}, {}], dtype=object)}
    out = TL.prepare_sample(batch, "cpu")
    assert isinstance(out["x"], torch.Tensor)
    np.testing.assert_array_equal(out["x"].numpy(), batch["x"])
    assert out["ids"] is batch["ids"] and out["obj"] is batch["obj"]
    loader = TL.DataLoader(_numbers(7), 2)
    got = list(TL.PrefetchLoader(loader, "cpu", depth=1))
    want = list(loader)
    assert len(got) == len(TL.PrefetchLoader(loader, "cpu")) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["x"].numpy(), w["x"])
        assert g["i"] == w["i"]

    class Broken:
        def __iter__(self):
            yield {"x": np.zeros(1)}
            raise RuntimeError("bad item")

    with pytest.raises(RuntimeError, match="bad item"):
        list(TL.PrefetchLoader(Broken(), "cpu"))
    # the card unless the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: TL.prepare_sample(batch),
                 lambda: TL.PrefetchLoader(loader)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
