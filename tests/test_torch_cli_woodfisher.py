"""The port's ``cli/evaluate_woodfisher.py`` vs the JAX CLI on the CPU, at
tiny fp32 size, on one synthetic VQA config (``tests/test_woodfisher.py``'s
three cases, and the artifact dumps).

The port's CLI builds its model from the same seed as JAX's; the tests
give it JAX's initial weights through the bridge (the factory's
``build_model`` is patched), so both CLIs start from one model.  Held
equal: the size stats (``orig_total_size``, ``distilled_total_size``) and
the eval results of the WoodFisher ``unstrct`` prune, of the block merges
(pairwise, and split ``vit|t5`` with weights and a regex) and of the prune
from reloaded importance files; the npz keys of each dump, and their values
within 1e-4 relative (importances) or equal (pruned indices, away from
tied scores); the answers of the merged model.  Also: every flag parses
to JAX's namespace, and with no GPU the default ``--device`` raises.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_cli_evaluate import _cfg
from vlm_compression_tpu_torch.cli import evaluate_woodfisher as TW


def _jax_variables(model_cfg, seed):
    import jax

    from vlm_compression_tpu.models import factory

    _, variables = factory.build_model(model_cfg, seed=seed)
    return jax.tree_util.tree_map(np.asarray, {
        k: v for k, v in variables.items() if k in ("params", "masks")})


@pytest.fixture
def jax_weights(monkeypatch):
    """The port's factory builds JAX's initial weights for the config and
    seed it is given.  JAX's factory returns its variables without the
    ``calib`` collection that its init sows: with it, JAX's
    ``get_activations`` reads the activations sown at init instead of the
    scoring batches' (a known difference, ROADMAP queue 3), and nothing
    else of the CLI reads it."""
    from vlm_compression_tpu.models import factory as jax_factory
    from vlm_compression_tpu_torch.models import factory
    from vlm_compression_tpu_torch.models.bridge import load_jax_variables

    port_build, jax_build = factory.build_model, jax_factory.build_model

    def build(model_cfg, seed=0, device=None):
        model = port_build(model_cfg, seed=seed, device=device)
        load_jax_variables(model, _jax_variables(dict(model_cfg), seed))
        return model

    def build_without_calib(model_cfg, seed=0):
        module, variables = jax_build(model_cfg, seed=seed)
        return module, {k: v for k, v in variables.items() if k != "calib"}

    monkeypatch.setattr(factory, "build_model", build)
    monkeypatch.setattr(jax_factory, "build_model", build_without_calib)


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    root = tmp_path_factory.mktemp("wfcli")
    return root, _cfg(root)


def _both(cfg, job, *flags):
    from vlm_compression_tpu.cli import evaluate_woodfisher as JW

    root, path = cfg
    argv = ["--cfg-path", path, "--tiny", *flags]
    want = JW.main([*argv, "--job_id", f"{job}-jax", "--options",
                    f"run.output_dir={root / job / 'jax'}"])
    got = TW.main([*argv, "--job_id", f"{job}-port", "--device", "cpu",
                   "--options", f"run.output_dir={root / job / 'port'}"])
    return want, got


def _answers(root, job, who):
    rows = json.loads((root / job / who / "result" /
                       "val_vqa_result.json").read_text())
    return {r["question_id"]: r["answer"] for r in rows}


def _same_stats(cfg, job, want, got):
    for key in ("orig_total_size", "distilled_total_size", "eval_results"):
        assert got[key] == want[key], key
    assert _answers(cfg[0], job, "port") == _answers(cfg[0], job, "jax")
    stats = json.loads((cfg[0] / job / "port" /
                        f"woodfisher_stats_{job}-port.json").read_text())
    assert stats["distilled_total_size"] == got["distilled_total_size"]


def test_woodfisher_unstructured_prune_eval(cfg, jax_weights):
    want, got = _both(cfg, "wf1", "--distillation_init",
                      "unstrct_woodfisher", "--get_derivative_info",
                      "--num_data", "2", "--distill_merge_ratio", "0.5")
    assert got["distilled_total_size"] < got["orig_total_size"]
    assert "val" in got["eval_results"]
    _same_stats(cfg, "wf1", want, got)


@pytest.mark.parametrize("flags", [
    ("--distilled_block_ids", "0,1", "--permute_before_merge"),
    ("--distilled_block_ids", "1,0|0;1", "--distilled_block_weights",
     "0.25,0.75|1;1", "--modules_to_merge", "mlp|ffn/wi_0"),
], ids=["pairwise_permuted", "split_weighted_regex"])
def test_block_merge_eval(cfg, jax_weights, flags):
    job = "wf2" if "0,1" in flags else "wf2s"
    want, got = _both(cfg, job, *flags)
    assert got["distilled_total_size"] < got["orig_total_size"] or \
        "|" in flags[1]
    _same_stats(cfg, job, want, got)


def _npz(path):
    with np.load(path, allow_pickle=True) as f:
        return {k: f[k] for k in f.files}


def test_save_importance_measure(cfg, jax_weights):
    want, got = _both(cfg, "wf3", "--get_activation_info", "--num_data",
                      "2", "--save_importance_measure")
    want, got = _npz(want), _npz(got)
    assert any(k.startswith("vit:") for k in got)
    assert any(k.startswith("t5:") for k in got)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                   atol=1e-6 * np.abs(v).max(), err_msg=k)


def test_save_woodfisher_measure_and_reload(cfg, jax_weights):
    """The WoodFisher scores dumped by both CLIs (keys equal, values within
    1e-4 relative); the port's dump read back by ``--vit_importance_measure``
    / ``--t5_importance_measure`` prunes as the JAX CLI does from its own."""
    want, got = _both(cfg, "wf5", "--distillation_init",
                      "unstrct_woodfisher", "--get_derivative_info",
                      "--num_data", "2", "--save_importance_measure")
    jw, tw = _npz(want), _npz(got)
    assert set(tw) == set(jw) and tw
    for k, v in jw.items():
        np.testing.assert_allclose(tw[k], v, rtol=1e-4,
                                   atol=1e-6 * np.abs(v).max(), err_msg=k)
    root = cfg[0]
    for who, payload in (("jax", jw), ("port", tw)):
        for tower in ("vit", "t5"):
            np.savez(root / f"{who}_{tower}.npz", **{
                k.split(":", 1)[1]: v for k, v in payload.items()
                if k.startswith(tower + ":")})
    from vlm_compression_tpu.cli import evaluate_woodfisher as JW

    base = ["--cfg-path", cfg[1], "--tiny", "--distillation_init",
            "unstrct", "--distill_merge_ratio", "0.5"]
    j = JW.main([*base, "--vit_importance_measure", str(root / "jax_vit.npz"),
                 "--t5_importance_measure", str(root / "jax_t5.npz"),
                 "--job_id", "wf6-jax", "--options",
                 f"run.output_dir={root / 'wf6' / 'jax'}"])
    t = TW.main([*base, "--vit_importance_measure",
                 str(root / "port_vit.npz"), "--t5_importance_measure",
                 str(root / "port_t5.npz"), "--job_id", "wf6-port",
                 "--device", "cpu", "--options",
                 f"run.output_dir={root / 'wf6' / 'port'}"])
    _same_stats(cfg, "wf6", j, t)


def test_save_pruned_indices(cfg, jax_weights):
    """The same count pruned from each leaf, and the same scores pruned:
    which of tied scores go (a zero bias's entries) is unspecified in both
    packages, so the pruned scores are compared as sorted lists, read off
    JAX's WoodFisher scores of the same model and samples."""
    from vlm_compression_tpu.cli import evaluate_woodfisher as JW

    flags = ["--distillation_init", "unstrct_woodfisher",
             "--get_derivative_info", "--num_data", "2"]
    want, got = _both(cfg, "wf7", *flags, "--save_pruned_indices")
    jw, tw = _npz(want), _npz(got)
    root = cfg[0]
    scores = _npz(JW.main(["--cfg-path", cfg[1], "--tiny", *flags,
                           "--save_importance_measure", "--job_id",
                           "wf7-scores", "--options",
                           f"run.output_dir={root / 'wf7' / 'scores'}"]))
    assert set(tw) == set(jw) and tw
    assert {k.split(":")[0] for k in tw} == {"vit", "t5"}
    for k, v in jw.items():
        assert tw[k].dtype == np.int32 and tw[k].shape == v.shape, k
        assert (np.diff(tw[k]) > 0).all(), k
        s = scores[k].reshape(-1)
        np.testing.assert_allclose(np.sort(s[tw[k]]), np.sort(s[v]),
                                   rtol=1e-4, atol=0, err_msg=k)


def test_save_final_activations(cfg, jax_weights):
    want, got = _both(cfg, "wf8", "--save_final_activations",
                      "--num_data", "2")
    jw, tw = _npz(want), _npz(got)
    assert set(tw) == set(jw) == {"logits", "texts"}
    assert list(tw["texts"]) == list(jw["texts"])
    np.testing.assert_allclose(tw["logits"], jw["logits"], atol=1e-4,
                               rtol=1e-4)


def test_every_flag_parses_as_jax():
    from vlm_compression_tpu.cli import evaluate_woodfisher as JW

    argv = ["--cfg-path", "x.yaml", "--options", "a=1", "--job_id", "j",
            "--distillation_init", "unstrct_woodfisher",
            "--distilled_block_ids", "0,1|2,3", "--distilled_block_weights",
            "1,1|1,1", "--modules_to_merge", "mlp", "--permute_before_merge",
            "--permute_on_block_before_merge", "--vit_ffn_ratio", "0.5",
            "--distilled_merge_ratio", "0.3", "--distill_merge_ratio", "0.4",
            "--exact", "--normalization", "--metric", "cos", "--to_one",
            "--importance", "--num_data", "8", "--power", "1",
            "--num_logits", "2", "--get_derivative_info",
            "--get_activation_info", "--use_input_activation",
            "--vision_weight", "0.1", "--save_pruned_indices",
            "--vit_pruned_indices", "a", "--t5_pruned_indices", "b",
            "--save_importance_measure", "--vit_importance_measure", "c",
            "--t5_importance_measure", "d", "--save_final_activations",
            "--tiny", "--seed", "3", "--side_pretrained_weight", "e",
            "--vit_side_pretrained_weight", "f"]
    for extra in ([], argv):
        port = vars(TW.parse_args(extra + ["--device", "cpu"]))
        assert port.pop("device") == "cpu"
        assert port == vars(JW.parse_args(extra))


def test_default_device_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.main(["--cfg-path", "unused.yaml"])
