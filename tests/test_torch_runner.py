"""The port's runner (its training half, checkpoints, ``RunnerIter``) and
the LAION stream vs the JAX package on the CPU.

- ``RunnerBase.train`` against JAX's on the tiny fp32 InstructBLIP-T5 with
  LoRA ranks 4 / 2 / 8 (seeded non-zero lora_b), from the same variables
  over the same batches: two epochs (warmup, then cosine) of one
  optimizer step at ``accum_grad_iters`` 3 over a finite loader of two
  batches, so the step's micro-batches are of ragged lengths (padded by
  ``_concat_micro_batches``) and the loader is re-entered mid-epoch.  The
  step count is equal and the learning rates are the JAX scheduler's at
  (epoch, i · accum), exactly.  Tolerances: the epochs' mean losses within
  1.1e-3 (the stats' three decimals, rounded on both sides); the trained
  LoRA's change from its start, as one vector, within 2e-3 of its norm.
  One KD step's LoRA agrees with JAX's within 1e-3·lr where the gradient
  is not near zero (``tests/test_torch_retrain.py``); Adam's division by
  |g| lets the entries near zero move by up to 2·lr, which the norm
  absorbs after two steps, as it does the rounding of each updated factor
  to fp32 (an ulp of a factor near 0.3 is 3e-8, 3e-4 of a 1e-4 step),
  while a wrong gradient would put the error near the norm itself.  Two steps, not more: each Adam step
  over fp32 gradients that differ in their last bits multiplies the
  trajectories' distance (5e-4 after two steps, 1e-2 after four on this
  model), so a longer run would measure that growth, not the port.
- A resumed epoch (``run.resume_ckpt_path`` at ``checkpoint_0``) gives
  the LoRA factors and AdamW state of an uninterrupted run bit for bit
  (both on the CPU, the same operations), with ``start_epoch`` from
  ``checkpoint_meta.json``; the best checkpoint reloads into a model.
- ``RunnerIter`` writes ``checkpoint_iter<n>`` after each inner epoch, as
  JAX's does (``tests/test_misc_components.py``), and trains from the
  LAION stream, which has no length.
- The LAION stream against JAX's ``LaionDataset`` on the cases of
  ``tests/test_datasets.py`` (brace expansion, shards split over
  processes, the sample cap, batches by draining, a missing storage path):
  the same samples, images bit-equal; members saved as ``.npy`` read by
  numpy.
"""

import io
import json
import os
import tarfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_models import random_masks, seeded_lora, tiny_lora_configs
from vlm_compression_tpu.common.config import ConfigNode as JConfigNode
from vlm_compression_tpu.compression.pruners.base import FlaxModel
from vlm_compression_tpu.datasets import builders as JB
from vlm_compression_tpu.datasets import items as JI
from vlm_compression_tpu.datasets import loaders as JL
from vlm_compression_tpu.models import blip2_t5_instruct as JBlip
from vlm_compression_tpu.runners.runner_base import RunnerBase as JRunner
from vlm_compression_tpu.tasks import retrain as JR
from vlm_compression_tpu_torch.common.config import ConfigNode
from vlm_compression_tpu_torch.common.optims import make_lr_scheduler
from vlm_compression_tpu_torch.datasets import builders as TB
from vlm_compression_tpu_torch.datasets import items as TI
from vlm_compression_tpu_torch.datasets import loaders as TL
from vlm_compression_tpu_torch.models import blip2_t5_instruct as TBlip
from vlm_compression_tpu_torch.models.bridge import flatten, load_jax_variables
from vlm_compression_tpu_torch.models.layers import SparseLinear
from vlm_compression_tpu_torch.runners import RunnerBase, RunnerIter
from vlm_compression_tpu_torch.runners.runner_base import (
    _concat_micro_batches,
)
from vlm_compression_tpu_torch.tasks import retrain as TR

KL_W, T_KD = 0.1, 1.0
RUN = dict(task="image_text_retrain", batch_size_train=8, max_epoch=2,
           iters_per_epoch=3, accum_grad_iters=3, init_lr=1e-3,
           min_lr=1e-4, warmup_lr=1e-4, warmup_steps=3, log_freq=1,
           valid_splits=[])


class Ragged:
    """16 samples of the tiny model's inputs in two blocks of 8 whose
    prompts and labels run to different lengths; the collater pads each
    batch to its own longest (prompts with 0 under a 0 mask, labels with
    -100)."""

    LENGTHS = ((3, 4, 2, 3), (5, 6, 3, 4))

    def __init__(self, seed=3):
        jcfg, _ = tiny_lora_configs()
        rng = np.random.default_rng(seed)
        img, v, qv = jcfg.vit.img_size, jcfg.t5.vocab_size, \
            jcfg.qformer.vocab_size
        self.items = []
        for i in range(8 * len(self.LENGTHS)):
            plo, phi, llo, lhi = self.LENGTHS[i // 8]
            t, lab = plo + i % (phi - plo + 1), llo + i % (lhi - llo + 1)
            self.items.append(dict(
                image=rng.standard_normal((img, img, 3)).astype(np.float32),
                input_ids=rng.integers(2, v, t).astype(np.int32),
                labels=rng.integers(2, v, lab).astype(np.int32),
                qformer_input_ids=rng.integers(2, qv, t).astype(np.int32)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def collater(self, items):
        out = {"image": np.stack([it["image"] for it in items])}
        for key, fill in (("input_ids", 0), ("labels", -100),
                          ("qformer_input_ids", 0)):
            n = max(len(it[key]) for it in items)
            out[key] = np.stack([np.pad(it[key], (0, n - len(it[key])),
                                        constant_values=fill)
                                 for it in items])
        for key, ids in (("attention_mask", "input_ids"),
                         ("qformer_attention_mask", "qformer_input_ids")):
            n = out[ids].shape[1]
            out[key] = np.stack([(np.arange(n) < len(it[ids])).astype(
                np.int32) for it in items])
        return out


def _variables(seed=21):
    """The tiny LoRA model's JAX variables (numpy): params, seeded
    non-zero lora_b, a random keep-mask on every linear."""
    jcfg, _ = tiny_lora_configs()
    ds = Ragged()
    b = ds.collater(ds.items[:2])
    jm = JBlip.Blip2T5Instruct(jcfg)
    v = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.key(seed), **{k: jnp.asarray(x) for k, x in b.items()},
        vit_mode="sparse_lora", llm_mode="sparse_lora",
        qformer_mode="sparse_lora"))
    rng = np.random.default_rng(seed)
    return jm, dict(params=v["params"], lora=seeded_lora(v["lora"], rng),
                    masks=random_masks(v["params"], rng))


def _port_model(variables):
    _, tcfg = tiny_lora_configs()
    tm = TBlip.Blip2T5Instruct(tcfg, device="cpu")
    load_jax_variables(tm, variables)
    return tm


def _port_runner(model, out, cls=RunnerBase, datasets=None, **run):
    cfg = ConfigNode({"run": dict(RUN, output_dir=str(out), **run)})
    cfg.run_cfg = cfg["run"]
    runner = cls(cfg, TR.ImageTextRetrainTask(KL_W, T_KD), model,
                 datasets or {"ragged": {"train": Ragged()}}, job_id="t")
    if datasets is None:
        # a finite loader in order: the step sees the blocks' lengths,
        # and runs out mid-epoch
        runner._dataloaders = {"train": TL.DataLoader(Ragged(), 8,
                                                      drop_last=True)}
    return runner


def _lora_vector(named):
    return np.concatenate([np.asarray(named[k]).ravel()
                           for k in sorted(named)])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
    jm, variables = _variables()
    cfg = JConfigNode({"run": dict(RUN, output_dir=str(root / "jax"))})
    cfg.run_cfg = cfg["run"]
    jrun = JRunner(cfg, JR.ImageTextRetrainTask(KL_W, T_KD),
                   FlaxModel(jm, jax.tree_util.tree_map(jnp.asarray,
                                                        variables)),
                   {"ragged": {"train": Ragged()}}, job_id="j")
    jrun._dataloaders = {"train": JL.DataLoader(Ragged(), 8,
                                                drop_last=True)}
    jstats = jrun.train()
    jlora = {".".join(p): np.asarray(a) for p, a in
             flatten(jrun.model.variables["lora"]).items()}

    trun = _port_runner(_port_model(variables), root / "port")
    tstats = trun.train()
    return dict(root=root, variables=variables, jstats=jstats,
                jstep=int(jrun.train_state.step), jlora=jlora,
                lora0={".".join(p): a for p, a in
                       flatten(variables["lora"]).items()},
                trun=trun, tstats=tstats)


def test_train_steps_and_learning_rates_equal_jax(trained):
    trun = trained["trun"]
    sched = make_lr_scheduler(RUN)
    from vlm_compression_tpu.common.optims import make_lr_scheduler as jls

    jsched = jls(RUN)
    want = [(e, 0, jsched(e, 0)) for e in range(2)]
    got = [(m["epoch"], m["iter"], m["lr"]) for m in trun.step_metrics]
    assert got == want
    assert [sched(e, i * 3) for e, i, _ in want] == [w for *_, w in want]
    assert want[0][2] == 1e-4 and want[1][2] == pytest.approx(5.5e-4)
    assert trun.train_state.step == trained["jstep"] == 2
    for m in trun.step_metrics:
        assert all(np.isfinite(m[k]) for k in ("loss", "ce", "kl"))
    assert list(trained["tstats"]) == list(trained["jstats"]) == [0, 1]
    for e in (0, 1):
        t, j = trained["tstats"][e], trained["jstats"][e]
        assert set(t) == set(j) == {"lr", "loss"}
        assert abs(float(t["loss"]) - float(j["loss"])) <= 1.1e-3


def test_trained_lora_equals_jax(trained):
    lora = {n: p.detach().numpy() for n, p in
            trained["trun"].train_state.lora.items()}
    assert set(lora) == set(trained["jlora"])
    start = _lora_vector(trained["lora0"])
    want = _lora_vector(trained["jlora"]) - start
    got = _lora_vector(lora) - start
    assert np.linalg.norm(want) > 0
    assert np.linalg.norm(got - want) <= 2e-3 * np.linalg.norm(want)


def test_epochs_checkpointed_and_base_untouched(trained):
    trun, variables = trained["trun"], trained["variables"]
    out = trained["root"] / "port"
    assert (out / "checkpoint_0").is_file() and (out / "checkpoint_1").is_file()
    meta = json.loads((out / "checkpoint_meta.json").read_text())
    assert meta == {"epoch": 1, "tag": "1", "best": False}
    payload = torch.load(out / "checkpoint_1", weights_only=True)
    assert set(payload) == {"lora", "opt_state", "step", "masks"}
    assert payload["step"] == 2
    masks = {".".join(p): m for p, m in flatten(variables["masks"]).items()}
    assert set(payload["masks"]) == set(masks)
    for name, m in masks.items():
        np.testing.assert_array_equal(payload["masks"][name].numpy(), m)
    params = {".".join(p): a for p, a in flatten(variables["params"]).items()}
    for name, p in trun.model.named_parameters():
        if name in params:
            np.testing.assert_array_equal(p.detach().numpy(), params[name])
    lines = (out / "log.txt").read_text().splitlines()
    assert [sorted(json.loads(x)) for x in lines] == \
        [["train_loss", "train_lr"]] * 2


def test_concat_micro_batches_pads_ragged_lengths():
    ds = Ragged()
    micro = [ds.collater(ds.items[:8]), ds.collater(ds.items[8:])]
    got = _concat_micro_batches(micro)
    from vlm_compression_tpu.runners.runner_base import (
        _concat_micro_batches as J,
    )

    want = J(micro)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["input_ids"].shape == (16, 6)
    assert (got["labels"][:8, 3:] == -100).all()
    assert (got["attention_mask"][:8, 4:] == 0).all()


def test_resumed_epoch_equals_an_uninterrupted_run(trained, tmp_path):
    variables = trained["variables"]
    first = _port_runner(_port_model(variables), tmp_path / "a",
                         max_epoch=1)
    first.train()
    ckpt = tmp_path / "a" / "checkpoint_0"
    resumed = _port_runner(_port_model(variables), tmp_path / "b",
                           resume_ckpt_path=str(ckpt))
    resumed.train()
    assert resumed.start_epoch == 1
    assert [m["epoch"] for m in resumed.step_metrics] == [1]
    whole = trained["trun"]
    for n, p in whole.train_state.lora.items():
        assert torch.equal(resumed.train_state.lora[n], p), n
    want, got = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    assert set(got["state"]) == set(want["state"])
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    assert resumed.train_state.step == whole.train_state.step == 2


def test_best_checkpoint_reloads_lora_and_masks(trained, tmp_path):
    trun = trained["trun"]
    trun._save_checkpoint(1, is_best=True)
    model = _port_model(trained["variables"])
    for m in model.modules():
        if isinstance(m, SparseLinear) and m.mask is not None:
            m.mask = torch.ones_like(m.mask)
    other = _port_runner(model, trun.output_dir)
    other._reload_best_model()
    for n, p in other.train_state.lora.items():
        assert torch.equal(p, trun.train_state.lora[n]), n
    for (n, a), (_, b) in zip(trun.model.named_modules(),
                              model.named_modules()):
        if isinstance(a, SparseLinear) and a.mask is not None:
            assert torch.equal(a.mask, b.mask), n
    os.remove(os.path.join(trun.output_dir, "checkpoint_best"))


def test_runner_iter_writes_iteration_checkpoints(trained, tmp_path):
    runner = _port_runner(_port_model(trained["variables"]), tmp_path,
                          cls=RunnerIter, max_iters=8,
                          iters_per_inner_epoch=4, accum_grad_iters=2)
    stats = runner.train()
    assert list(stats) == [0, 1]                   # two inner epochs
    assert (tmp_path / "checkpoint_iter4").is_file()
    assert (tmp_path / "checkpoint_iter8").is_file()
    assert json.loads((tmp_path / "checkpoint_meta.json").read_text()) == \
        {"epoch": -1, "tag": "iter8", "best": False}
    assert runner.train_state.step == 4             # 2 of 2 batches each
    assert list(runner.train(prune_retrain=True)) == [0]   # one inner epoch
    assert runner.train_state.step == 6


# ------------------------------------------------------------------ LAION
def _shards(root, n_shards, per, seed, npy=False):
    """Tar shards of (image, caption) pairs as webdataset lays them out:
    JPEGs (or .npy arrays) with a .json caption; one key without an image
    and one .txt caption in the first shard."""
    rng = np.random.RandomState(seed)
    for s in range(n_shards):
        with tarfile.open(root / f"{s:05d}.tar", "w") as tf:
            def add(name, blob):
                info = tarfile.TarInfo(name)
                info.size = len(blob)
                tf.addfile(info, io.BytesIO(blob))

            for i in range(per):
                key = f"s{s}_k{i}"
                arr = rng.randint(0, 255, (40, 40, 3), np.uint8)
                buf = io.BytesIO()
                if npy:
                    np.save(buf, arr)
                    add(key + ".npy", buf.getvalue())
                else:
                    Image.fromarray(arr).save(buf, format="JPEG")
                    add(key + ".jpg", buf.getvalue())
                if s == 0 and i == 1:
                    add(key + ".txt", f"txt {key}".encode())
                else:
                    add(key + ".json",
                        json.dumps({"caption": f"cap {key}"}).encode())
            if s == 0:
                add("orphan.json", b'{"caption": "no image"}')


def _builders(storage, size=32):
    cfg = {"build_info": {"storage": storage},
           "vis_processor": {"train": {"name": "blip_image_eval",
                                       "image_size": size}},
           "text_processor": {"train": {"name": "blip_caption"}}}
    return JB.load_builder("laion2B_multi", cfg), \
        TB.load_builder("laion2B_multi", cfg)


def _assert_samples_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        np.testing.assert_array_equal(g["image"], w["image"])
        for k in ("text_input", "text_output", "image_id", "instance_id"):
            assert g[k] == w[k], k


def test_expand_braces_equals_jax():
    for pat in ("/x/{00003..00005}.tar", "/x/{00..01}/{003..004}.tar",
                "/x/plain.tar", "/x/{9..11}.tar"):
        assert TI.expand_braces(pat) == JI.expand_braces(pat)
    assert TI.expand_braces("/x/{00..01}/{003..004}.tar") == [
        "/x/00/003.tar", "/x/00/004.tar", "/x/01/003.tar", "/x/01/004.tar"]


def test_laion_stream_equals_jax(tmp_path):
    _shards(tmp_path, 2, 3, seed=1)
    storage = str(tmp_path / "{00000..00001}.tar")
    jb, tb = _builders(storage)
    want, got = jb.build_datasets(), tb.build_datasets()
    assert set(got) == set(want) == {"train"}
    samples = list(got["train"])
    _assert_samples_equal(samples, list(want["train"]))
    assert len(samples) == 6                      # the orphan key skipped
    assert samples[1]["text_input"] == "txt s0_k1"
    batch = got["train"].collater(samples[:2])
    assert batch["image"].shape == (2, 32, 32, 3)

    # the shards split over two processes: disjoint, together all of them
    procs = [(JI.LaionDataset(jb._processor("vis", "train"),
                              jb._processor("text", "train"), storage,
                              process_index=r, process_count=2),
              TI.LaionDataset(tb._processor("vis", "train"),
                              tb._processor("text", "train"), storage,
                              process_index=r, process_count=2))
             for r in range(2)]
    ids = []
    for j, t in procs:
        _assert_samples_equal(list(t), list(j))
        ids.append({s["instance_id"] for s in t})
    assert ids[0] and ids[1] and not ids[0] & ids[1]
    assert len(ids[0] | ids[1]) == 6


def test_laion_stream_through_the_loader_equals_jax(tmp_path):
    _shards(tmp_path, 1, 5, seed=3)
    jb, tb = _builders(str(tmp_path / "{00000..00000}.tar"))
    # the sample cap flows through the builder into the stream
    capped = tb.build_datasets(max_train_samples=2)["train"]
    _assert_samples_equal(list(capped),
                          list(jb.build_datasets(max_train_samples=2)
                               ["train"]))
    assert len(list(capped)) == 2
    jds, tds = jb.build_datasets()["train"], tb.build_datasets()["train"]
    for drop_last, sizes in ((False, [2, 2, 1]), (True, [2, 2])):
        tl = TL.DataLoader(tds, batch_size=2, drop_last=drop_last)
        jl = JL.DataLoader(jds, batch_size=2, drop_last=drop_last)
        with pytest.raises(TypeError, match="runner_iter"):
            len(tl)
        tbs, jbs = list(tl), list(jl)
        assert [b["image"].shape[0] for b in tbs] == sizes
        for g, w in zip(tbs, jbs):
            np.testing.assert_array_equal(g["image"], w["image"])
            assert g["text_input"] == w["text_input"]
    with pytest.raises(FileNotFoundError):
        TI.LaionDataset(tb._processor("vis", "train"),
                        tb._processor("text", "train"),
                        str(tmp_path / "nope" / "{00000..00002}.tar"))


def test_laion_npy_members_read_with_numpy(tmp_path):
    """Shards whose images are .npy (the card's machine has no Pillow):
    the same samples as the JPEG-free arrays through the processor."""
    _shards(tmp_path, 1, 3, seed=4, npy=True)
    _, tb = _builders(str(tmp_path / "00000.tar"))
    samples = list(tb.build_datasets()["train"])
    assert [s["instance_id"] for s in samples] == ["s0_k0", "s0_k1",
                                                   "s0_k2"]
    rng = np.random.RandomState(4)
    proc = tb._processor("vis", "train")
    for s in samples:
        arr = rng.randint(0, 255, (40, 40, 3), np.uint8)
        np.testing.assert_array_equal(s["image"], proc(arr))


def test_runner_iter_trains_from_the_laion_stream(tmp_path):
    """RunnerIter over the stream (no length): two inner epochs of two
    steps through the T5 batch preparer, the LoRA moved, finite losses."""
    from vlm_compression_tpu_torch.datasets.tokenization import (
        load_tokenizer,
    )
    from vlm_compression_tpu_torch.tasks.preparers import (
        make_t5_batch_preparer,
    )

    _shards(tmp_path, 2, 4, seed=5)
    _, variables = _variables(seed=5)
    model = _port_model(variables)
    cfg = model.cfg
    _, tb = _builders(str(tmp_path / "{00000..00001}.tar"),
                      size=cfg.vit.img_size)
    ds = tb.build_datasets()
    prepare = make_t5_batch_preparer(
        load_tokenizer(None, vocab_size=cfg.t5.vocab_size),
        load_tokenizer(None, vocab_size=cfg.qformer.vocab_size))
    runner = _port_runner(model, tmp_path / "out", cls=RunnerIter,
                          datasets={"laion": ds}, max_iters=8,
                          iters_per_inner_epoch=4, accum_grad_iters=1,
                          batch_size_train=2)
    runner.prepare_batch = prepare
    before = _lora_vector({n: p.detach().numpy().copy()
                           for n, p in runner.train_state.lora.items()})
    assert list(runner.train()) == [0, 1]
    after = _lora_vector({n: p.detach().numpy()
                          for n, p in runner.train_state.lora.items()})
    assert not np.array_equal(after, before)
    assert len(runner.step_metrics) == 8
    assert all(np.isfinite(m["loss"]) for m in runner.step_metrics)
    assert (tmp_path / "out" / "checkpoint_iter8").is_file()
