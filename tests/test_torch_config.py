"""The port's config layer vs PyYAML and the JAX package on the CPU: the
YAML-subset reader (``common/_yaml.py``) equals ``yaml.safe_load`` on every
yaml under ``configs/`` and on hand-written documents, and raises outside
its subset; the scalar resolver equals ``yaml.safe_load`` on generated
scalars and on every ``--options`` value the launchers build; ``Config``
(model defaults merged, dot overrides applied) equals the JAX ``Config``
for every project yaml of an arch the port builds; the registry's kinds,
paths, state and deferred registration, and its misses.  Every comparison
is exact (``==`` on the trees; NaN equal to NaN).
"""

import math
import sys
import types
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from vlm_compression_tpu.common import config as JC
from vlm_compression_tpu.models import model_zoo as JZ
from vlm_compression_tpu_torch.common import _yaml as Y
from vlm_compression_tpu_torch.common import config as TC
from vlm_compression_tpu_torch.common.registry import Registry, registry
from vlm_compression_tpu_torch.models import model_zoo as TZ

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = sorted((ROOT / "configs").rglob("*.yaml"))
PORT_ARCHS = ("blip2_t5_instruct", "blip2_vicuna_instruct", "blip2",
              "blip2_feature_extractor", "blip2_image_text_matching")


def _same(a, b) -> bool:
    """Equal trees, types included (1 is not True, 1.0 is not 1); NaN
    equals NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _both(text):
    """(the reader's value or its error type, PyYAML's)."""
    try:
        want = yaml.safe_load(text)
    except (yaml.YAMLError, ValueError) as exc:
        want = exc
    try:
        got = Y.safe_load(text)
    except ValueError as exc:
        got = exc
    return got, want


@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: str(p.relative_to(ROOT / "configs")))
def test_reader_equals_safe_load_on_every_config(path):
    text = path.read_text()
    assert _same(Y.safe_load(text), yaml.safe_load(text))


DOCS = [
    "a: 1\nb:\n  c: [x, 'y z', \"q\\tr\"]\n  d: {k: v, e: [], f: {}}\n",
    "test_splits:\n- val\n- test\nn: 3\n",
    "- a: 1\n  b:\n  - 2\n  - - 3\n    - 4\n- c\n-\n- {x: 1}\n",
    "key:   value with  spaces   # a comment\nurl: https://h/x.pth\n",
    "'quoted key': 'it''s'\n\"k2\": \"a\\u00e9\\x41\"\n"
    "1: int key\nnull: n\n",
    "# only a comment\n\n",
    "",
    "x:\n  y:\n    z: 1e-6\n  w: 1.0e-06\n"
    "  v: [1.5, -2, 0x1F, 0o7, 07, 1_000, .inf, -.Inf, .NaN]\n",
    "a: yes\nb: Off\nc: ~\nd:\ne: 2020-01-02\nf: 2001-12-14 21:59:43.10 -5\n",
    "[a, [b, c], {d: e}, ]\n",
    "{a: 1, b}\n",
    "plain\n",
    "a: b\na: c\n",
    "a:\n  - 1\n  - 2\nb: 3\n",
    "top:\n    deep:\n        - x\n    back: 1\n",
    "---\na: 1\n...\n", "--- [1, x]\n", "--- # c\n", "---\n...\n",
]


@pytest.mark.parametrize("text", DOCS, ids=range(len(DOCS)))
def test_reader_equals_safe_load_on_documents(text):
    got, want = _both(text)
    assert not isinstance(want, Exception), want
    assert _same(got, want)


OUTSIDE = ["a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  text\n",
           "a: >\n  text\n", "? a\n: b\n",
           "a: 'open\n  quote'\n", "a: [1,\n  2]\n", "a: b\n  c\n",
           "a: x: y\n", "\ta: 1\n", "a: - 1\n", "%YAML 1.1\n---\na: 1\n",
           "a: =\n", "<<: 1\n", "a: 1\n---\nb: 2\n", "--- a: 1\n",
           "...\n", "a\n...\nb\n"]


@pytest.mark.parametrize("text", OUTSIDE, ids=range(len(OUTSIDE)))
def test_reader_raises_outside_its_subset(text):
    with pytest.raises(ValueError):
        Y.safe_load(text)


_SCALAR = st.one_of(
    st.text(alphabet="0123456789+-._eExXbBo:", max_size=10),
    st.text(alphabet="0123456789abcdefnNtTyYlLuUrRsS~.-_ ", max_size=8),
    st.sampled_from(["yes", "No", "TRUE", "off", "On", "null", "Null", "~",
                     ".inf", "-.INF", ".nan", ".NaN", "0", "-0", "00",
                     "0b101", "-0x_1f", "0_7", "08", "1:30", "-1:30.5",
                     "190:20:30", "1__2", "1.", "-.5", ".5e+3", "1.0e5",
                     "1.0e+5", "2001-12-14", "2001-12-14t21:59:43.10-05:00",
                     "2001-12-14 21:59:43.10 +5", "2002-1-1 1:02:03Z",
                     "a#b", "x_y", "-x", ":x", "?x", "=", "<<"]),
    st.floats(allow_nan=True).map(repr),
    st.integers().map(str))


@settings(max_examples=400, deadline=None)
@given(text=_SCALAR)
def test_scalar_resolver_equals_safe_load(text):
    got, want = _both(text)
    if isinstance(want, Exception):
        assert isinstance(got, Exception), (text, got)
    else:
        assert _same(got, want), (text, got, want)
        assert _same(TC._parse_scalar(text), JC._parse_scalar(text))


def _launcher_commands(monkeypatch):
    """Every command line ``scripts/launch_lib.py`` builds for its grid
    (prune-and-eval, RESSA training, checkpoint eval; T5 and Vicuna)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import launch_lib
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    cmds = []
    monkeypatch.setattr(launch_lib, "_run", cmds.append)
    for pruner in launch_lib.METHOD_MATRIX:
        for family in ("t5", "vicuna"):
            launch_lib.prune_and_eval(pruner, 0.5, 0.5, family=family)
            launch_lib.train_ressa(pruner, 0.5, 0.5, family=family)
        launch_lib.prune_and_eval(pruner, 0.5, 0.5, prune_n=2, prune_m=4,
                                  instruct=False)
    launch_lib.eval_checkpoint("output/x/checkpoint_best")
    launch_lib.eval_checkpoint("output/x/checkpoint_best", family="vicuna")
    return cmds


def _options(cmd):
    if "--options" not in cmd:
        return []
    out = []
    for arg in cmd[cmd.index("--options") + 1:]:
        if arg.startswith("--"):
            break
        out.append(arg)
    return out


def test_scalar_resolver_on_every_launcher_option(monkeypatch):
    values = [o.split("=", 1)[1] for c in _launcher_commands(monkeypatch)
              for o in _options(c)]
    assert values
    for v in values + ["[data/a.json, data/b.json]", "'Question: {}'",
                       "0.5", "true", "1e-4", "null", ""]:
        assert _same(TC._parse_scalar(v), JC._parse_scalar(v)), v
        assert _same(TC._parse_scalar(v), yaml.safe_load(v)), v


def _port_arch_projects():
    out = []
    for p in sorted((ROOT / "configs" / "projects").rglob("*.yaml")):
        arch = ((yaml.safe_load(p.read_text()) or {}).get("model")
                or {}).get("arch")
        if arch in PORT_ARCHS:
            out.append(p)
    return out


OPTIONS = ["run.output_dir=output/job-1", "run.num_beams=3",
           "model.model_type=xl", "run.seed=7",
           "datasets.gqa.build_info.annotations.val=[/d/a.json, /d/b.json]",
           "datasets.gqa.build_info.images.storage=/d/images",
           "run.prompt='Question: {} Answer:'", "run.init_lr=1e-4",
           "model.new.deep.key=null"]


@pytest.mark.parametrize("path", _port_arch_projects(),
                         ids=lambda p: str(p.relative_to(ROOT / "configs")))
@pytest.mark.parametrize("options", [None, OPTIONS], ids=["plain", "options"])
def test_config_equals_jax(path, options):
    want = JC.Config(cfg_path=str(path), options=options,
                     defaults=JZ.default_config_path)
    got = TC.Config(cfg_path=str(path), options=options,
                    defaults=TZ.default_config_path)
    assert _same(got.to_dict(), want.to_dict())
    for sec in ("model_cfg", "datasets_cfg", "run_cfg"):
        assert _same(getattr(got, sec).to_dict(),
                     getattr(want, sec).to_dict())


def test_config_from_a_tree_and_mapping_defaults_equals_jax(tmp_path):
    default = tmp_path / "default.yaml"
    default.write_text("model:\n  arch: a\n  x: 1\n  sub: {p: 1, q: 2}\n")
    tree = {"model": {"arch": "a", "sub": {"q": 3}},
            "run": {"list": [{"k": 1}]}}
    for defaults in ({"a": str(default)},
                     lambda arch, mt: str(default) if arch == "a" else None):
        want = JC.Config(tree=tree, defaults=defaults,
                         options=["run.z=2", "model.sub.r=[1, 2]"])
        got = TC.Config(tree=tree, defaults=defaults,
                        options=["run.z=2", "model.sub.r=[1, 2]"])
        assert _same(got.to_dict(), want.to_dict())
        assert got.model_cfg.sub.q == 3 and got.model_cfg.x == 1
    with pytest.raises(ValueError):
        TC.apply_dot_overrides(TC.ConfigNode(), ["no_equals_sign"])


def test_config_node_equals_jax():
    data = {"a": {"b": [1, {"c": 2}]}, "d": 3}
    j, t = JC.ConfigNode(data), TC.ConfigNode(data)
    for n in (j, t):
        n.set_path("a.e.f", 4)
        n.set_path("d.g", 5)                # replaces a scalar
        n.merge({"a": {"b": [9], "h": {"i": 1}}, "k": None})
        n.x = {"y": 1}
    assert _same(t.to_dict(), j.to_dict())
    assert t.get_path("a.e.f") == j.get_path("a.e.f") == 4
    assert t.get_path("a.nope", "dft") == "dft"
    assert t.x.y == 1 and isinstance(t.x, TC.ConfigNode)
    assert _same(t.copy().to_dict(), t.to_dict())
    assert t.pretty() == j.pretty()
    with pytest.raises(AttributeError):
        t.missing


def test_model_zoo_equals_jax():
    assert TZ.MODEL_CONFIG_PATHS == JZ.MODEL_CONFIG_PATHS
    for arch, types_ in JZ.MODEL_CONFIG_PATHS.items():
        for mt in list(types_) + [None, "unknown"]:
            assert TZ.default_config_path(arch, mt) == \
                JZ.default_config_path(arch, mt)
    assert TZ.default_config_path("nope") is None


@pytest.mark.parametrize("kind", ["model", "task", "builder", "processor",
                                  "pruner", "lr_scheduler", "runner"])
def test_registry_kinds(kind):
    reg = Registry()
    cls = type("C", (), {})
    getattr(reg, f"register_{kind}")("name")(cls)
    assert getattr(reg, f"get_{kind}_class")("name") is cls
    assert reg.list_names(kind) == ["name"]
    getattr(reg, f"register_{kind}")("name")(cls)     # the same class again
    with pytest.raises(KeyError):
        getattr(reg, f"register_{kind}")("name")(type("D", (), {}))
    with pytest.raises(KeyError, match="not ported yet"):
        getattr(reg, f"get_{kind}_class")("missing")


def test_registry_lazy_paths_and_state():
    reg = Registry()
    calls = []

    def loader():
        calls.append(1)
        reg.register_model("late")(types.SimpleNamespace)

    reg.register_lazy("model", loader)
    assert reg.get_model_class("late") is types.SimpleNamespace
    assert calls == [1]
    with pytest.raises(KeyError, match="not ported yet"):
        reg.get_model_class("never")
    assert calls == [1]                     # a loader runs once
    reg.register_lazy("task", lambda: reg.register_task("t")(int))
    assert reg.list_names("task") == ["t"]
    reg.register_path("cache_root", "/c")
    assert reg.get_path("cache_root") == "/c"
    reg.register("k", 5)
    assert reg.get("k") == 5 and reg.get("absent", 1) == 1


def test_port_registry_names_what_it_builds():
    import vlm_compression_tpu_torch.datasets  # noqa: F401
    import vlm_compression_tpu_torch.runners  # noqa: F401
    import vlm_compression_tpu_torch.tasks  # noqa: F401

    assert "image_text_pretrain" in registry.list_names("task")
    assert registry.list_names("runner") == ["runner_base", "runner_iter"]
    for name in ("gqa", "prefix_conceptual_caption_3m", "flickr30k"):
        assert name in registry.list_names("builder")
    for name in ("blip_image_eval", "blip2_image_train", "clip_image_eval",
                 "blip_caption", "blip_question"):
        assert name in registry.list_names("processor")
    with pytest.raises(KeyError, match="not ported yet"):
        registry.get_builder_class("no_such_dataset")
