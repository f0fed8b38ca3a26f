"""Rules of the PyTorch/CUDA port that hold without a card: what it may
import, where its entry points run, and that its kernel wrappers never
fall back to the plain versions on a device they do not serve."""

import ast
import re
from pathlib import Path

import pytest
import torch

import vlm_compression_tpu_torch
from vlm_compression_tpu_torch.common.device import resolve_device
from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
    Blip2T5Instruct,
    Blip2T5InstructConfig,
)
from vlm_compression_tpu_torch.ops import _cuda
from vlm_compression_tpu_torch.ops import attention as TA
from vlm_compression_tpu_torch.ops import masked_linear as TML
from vlm_compression_tpu_torch.ops import quant as TQ

ROOT = Path(__file__).resolve().parents[1]
PORT = Path(vlm_compression_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vlm_compression_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py"))


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files() + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for mod in _imported_modules(tree):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def _module_level_imports(tree):
    """The modules a file imports when it is itself imported: every import
    outside a function body (class bodies and ``if``/``try`` blocks at
    module level run at import time)."""
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module
        todo.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_host_only_package_at_module_level(path):
    """The card's machine has no PIL, yaml, spaCy, transformers or nltk: a
    module of the port may import them only inside the function that needs
    them (the HF tokenizer from a local path, the spaCy probe)."""
    tree = ast.parse(path.read_text())
    for mod in _module_level_imports(tree):
        top = mod.split(".")[0]
        assert top not in ("PIL", "yaml", "spacy", "transformers", "nltk"), \
            f"{path.name} imports {mod} at module level"


@pytest.mark.parametrize("path", _port_files() + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_nltk_anywhere(path):
    """The card's machine has no nltk, and the caption metrics run there:
    the port carries its own copies of the Treebank tokenizer and the
    Porter stemmer, and no file imports nltk, at module level or inside a
    function."""
    tree = ast.parse(path.read_text())
    for mod in _imported_modules(tree):
        assert mod.split(".")[0] != "nltk", f"{path.name} imports {mod}"
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            assert not str(node.args[0].value).startswith("nltk"), path.name


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_calls_no_library_attention(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        name = (node.attr if isinstance(node, ast.Attribute)
                else node.id if isinstance(node, ast.Name) else None)
        assert name != "scaled_dot_product_attention", path.name


def test_entry_points_need_a_device_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Blip2T5Instruct(Blip2T5InstructConfig.tiny())
    assert resolve_device("cpu") == torch.device("cpu")
    m = Blip2T5Instruct(Blip2T5InstructConfig.tiny(), device="cpu")
    assert m.device == torch.device("cpu")
    # the CLIs' entry points: the card unless --device says otherwise
    from vlm_compression_tpu_torch.cli import evaluate, train

    for cli in (evaluate, train):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.run(cli.parse_args(["--cfg-path", "unused.yaml"]))


def test_wrappers_raise_instead_of_falling_back():
    """Off the CPU a wrapper launches its kernel or raises: a device the
    kernels do not serve is refused, never routed to the plain version."""
    x = torch.empty(4, 8, device="meta")
    w = torch.empty(8, 16, device="meta")
    mask = torch.empty(8, 16, dtype=torch.bool, device="meta")
    before = TML.launches
    with pytest.raises(ValueError, match="unsupported device"):
        TML.masked_matmul(x, w, mask)
    q = torch.empty(1, 3, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TA.attention_core(q, q, q)
    assert TML.launches == before


def test_new_wrappers_raise_instead_of_falling_back():
    """The sparse-LoRA and attention-backward (dq, dk/dv, dbias) wrappers,
    forward and under autograd, refuse a device the kernels do not
    serve."""
    x = torch.empty(4, 8, device="meta")
    w = torch.empty(8, 16, device="meta")
    mask = torch.empty(8, 16, dtype=torch.bool, device="meta")
    a = torch.empty(8, 2, device="meta", requires_grad=True)
    b = torch.empty(2, 16, device="meta", requires_grad=True)
    counts = (TML.lora_launches, TA.dq_launches, TA.dkv_launches,
              TA.dbias_launches)
    for grad in (False, True):
        with torch.set_grad_enabled(grad), \
                pytest.raises(ValueError, match="unsupported device"):
            TML.sparse_lora_matmul(x, w, mask, a, b, 8.0)
    q = torch.empty(1, 3, 2, 8, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="unsupported device"):
        TA.attention_core(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        TA.flash_attention_backward(q, q, q, q, torch.empty(1, 2, 3),
                                    q, ())
    bias = torch.empty(1, 2, 3, 3, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="unsupported device"):
        TA.flash_attention_dbias(q, q, q, q, torch.empty(1, 2, 3), q,
                                 [bias], 0)
    with pytest.raises(ValueError, match="unsupported device"):
        TA.attention_core(q.detach(), q.detach(), q.detach(), [bias])
    assert (TML.lora_launches, TA.dq_launches, TA.dkv_launches,
            TA.dbias_launches) == counts


@pytest.mark.parametrize("loop", [None, TML.WMMA])
@pytest.mark.parametrize("grad", [False, True])
def test_hopper_loop_wrappers_raise_instead_of_falling_back(grad, loop):
    """At a shape the Hopper loop would run (and with the WMMA loop forced)
    the masked, packed and sparse-LoRA wrappers refuse a device the kernels
    do not serve, forward and under autograd: no launch is counted, on
    either loop."""
    x = torch.empty(32896, 1408, device="meta", requires_grad=grad)
    w = torch.empty(1408, 6144, device="meta")
    mask = torch.empty(1408, 6144, dtype=torch.bool, device="meta")
    packed = torch.empty(88, 6144, dtype=torch.int32, device="meta")
    a = torch.empty(1408, 4, device="meta", requires_grad=grad)
    b = torch.empty(4, 6144, device="meta", requires_grad=grad)
    assert TML.plan(32896, 6144, 1408, 132, rank=4)[0] == TML.WGMMA
    counts = (TML.launches, TML.packed_launches, TML.lora_launches,
              TML.wgmma_launches)
    for call in (lambda: TML.masked_matmul(x, w, mask, _loop=loop),
                 lambda: TML.masked_matmul_packed(x, w, packed, _loop=loop),
                 lambda: TML.sparse_lora_matmul(x, w, mask, a, b, 4.0,
                                                _loop=loop)):
        with torch.set_grad_enabled(grad), \
                pytest.raises(ValueError, match="unsupported device"):
            call()
    assert (TML.launches, TML.packed_launches, TML.lora_launches,
            TML.wgmma_launches) == counts


@pytest.mark.parametrize("grad", [False, True])
def test_compressed_wrappers_raise_instead_of_falling_back(grad):
    """The packed-mask and int8 wrappers refuse a device the kernels do not
    serve, forward and under autograd."""
    x = torch.empty(4, 256, device="meta", requires_grad=grad)
    w = torch.empty(256, 16, device="meta")
    packed = torch.empty(16, 16, dtype=torch.int32, device="meta")
    q = torch.empty(256, 16, dtype=torch.int8, device="meta")
    scale = torch.empty(16, device="meta")
    counts = (TML.packed_launches, TQ.int8_launches)
    with pytest.raises(ValueError, match="unsupported device"):
        TML.masked_matmul_packed(x, w, packed)
    for mask in (None, packed):
        with pytest.raises(ValueError, match="unsupported device"):
            TQ.int8_matmul(x, q, scale, mask)
    assert (TML.packed_launches, TQ.int8_launches) == counts


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setenv("VCT_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build(["masked_matmul"])


def test_backward_without_its_library_raises(monkeypatch, tmp_path):
    """The TMA + wgmma backward on a tensor the kernels serve, with its
    library not built and no nvcc to build it: the wrapper raises; it does
    not fall back to the plain version, and counts no launch."""
    import torch.utils.cpp_extension as cpp

    monkeypatch.setenv("VCT_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(TA, "_on_card", lambda t: True)
    q = torch.zeros(2, 257, 4, 88, dtype=torch.bfloat16)
    lse = torch.zeros(2, 4, 257)
    assert TA.plan(257, 257, 88) == TA.WGMMA
    counts = (TA.bwd_wgmma_launches, TA.dq_launches, TA.dkv_launches,
              TA.delta_launches)
    for impl in (None, TA.MMA):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            TA.flash_attention_backward(q, q, q, q, lse, q, _impl=impl)
    assert (TA.bwd_wgmma_launches, TA.dq_launches, TA.dkv_launches,
            TA.delta_launches) == counts


@pytest.mark.parametrize("m,n,k", [(20, 2048, 5120), (20, 5120, 2048),
                                   (7, 77, 1001), (32896, 6144, 1408),
                                   (1, 1, 1), (288, 768, 3072)])
def test_split_k_covers_k_exactly_once(m, n, k):
    splits, k_split = TML.split_k(m, n, k, sms=132)
    assert k_split % 32 == 0 and splits >= 1
    assert (splits - 1) * k_split < k <= splits * k_split
    if m >= 4096:
        assert splits == 1     # calibration shapes fill the card unsplit


def test_kernel_sources_export_the_bound_entry_points():
    for name, fns in _cuda._SIGNATURES.items():
        src = (_cuda.CSRC / f"{name}.cu").read_text()
        assert "sm_90a" in src or "Hopper" in src
        for fn, argtypes in fns.items():
            m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
            assert m, fn
            assert len(m.group(1).split(",")) == len(argtypes), fn
    # the Hopper loop's entry points take the float32 ones' arguments, then
    # the split plan (splits, k_split) before the stream
    sigs = _cuda._SIGNATURES
    I, P = sigs["masked_matmul"]["masked_matmul_f32"][-2:]
    for kind in ("masked_matmul", "masked_matmul_packed",
                 "sparse_lora_matmul"):
        assert sigs["masked_matmul_wgmma"][f"{kind}_wgmma"] == \
            sigs["masked_matmul"][f"{kind}_f32"][:-1] + [I, I, P], kind
    assert sigs["int8_matmul_wgmma"]["int8_matmul_wgmma"] == \
        sigs["int8_matmul"]["int8_matmul_f32"][:-1] + [I, I, P]


def test_the_hopper_loop_is_tma_wgmma_and_mbarriers():
    """The Hopper main loop is built from TMA loads, mbarrier stages,
    warpgroup MMAs and register rebalancing, and the Hopper entry points'
    source includes it.  The PTX wrappers live in ``hopper.cuh``, which the
    loop includes."""
    loop = (_cuda.CSRC / "wgmma_tile.cuh").read_text()
    assert '#include "hopper.cuh"' in loop
    src = loop + (_cuda.CSRC / "hopper.cuh").read_text()
    for ptx in ("cp.async.bulk.tensor.2d", "mbarrier.try_wait.parity",
                "mbarrier.arrive.expect_tx", "wgmma.mma_async",
                "wgmma.wait_group", "setmaxnreg", "fence.proxy.async"):
        assert ptx in src, ptx
    assert '#include "wgmma_tile.cuh"' in (
        _cuda.CSRC / "masked_matmul_wgmma.cu").read_text()
    assert "masked_matmul_wgmma" in _cuda.SOURCES


def test_the_attention_backward_is_tma_wgmma_and_mbarriers():
    """The bf16 attention backward's main kernel loads its tiles by TMA
    through an mbarrier ring and multiplies with warpgroup MMAs (SS and
    RS), from the shared Hopper helpers, which the matmuls' loop uses
    too; dq is summed over slabs a kv tile by the cast, a broadcast dbias
    over its (batch, head) tiles by a pass of its own; its source builds on
    its own."""
    src = (_cuda.CSRC / "flash_attention_bwd_wgmma.cu").read_text()
    hopper = (_cuda.CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    for call in ("tma_load_4d", "bulk_load", "mbar_expect_tx", "mbar_wait",
                 "mbar_arrive", "wgmma_ss_n64", "wgmma_rs_dp",
                 "wgmma_ss_dp", "wgmma_commit", "wgmma_wait", "setmaxnreg",
                 "fence.proxy.async", "dbias_tile", "flash_bwd_delta_kernel",
                 "flash_bwd_dq_cast_kernel", "flash_bwd_dbias_sum_kernel"):
        assert call in src, call
    for ptx in ("cp.async.bulk.tensor.4d", "cp.async.bulk.shared",
                "mbarrier.try_wait.parity", "mbarrier.arrive.expect_tx",
                "wgmma.mma_async.sync.aligned.m64n64k16",
                "wgmma.mma_async.sync.aligned.m64n96k16"):
        assert ptx in hopper, ptx
    assert '#include "hopper.cuh"' in (_cuda.CSRC / "wgmma_tile.cuh") \
        .read_text()
    assert "flash_attention_bwd_wgmma" in _cuda.SOURCES


def _code(src: str) -> str:
    """A CUDA source with its comments stripped."""
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", src, flags=re.S)


def test_the_attention_backward_has_no_atomics():
    """The bf16 attention backward sums dq over the kv tiles, and a dbias
    over the batches and heads it broadcasts, in one fixed order, and no
    block waits on another: its code (comments stripped) and the helpers it
    includes hold no atomic add, no reduction instruction, no atomic
    operation and no acquire load to poll a flag with."""
    code = _code((_cuda.CSRC / "flash_attention_bwd_wgmma.cu").read_text())
    hopper = _code((_cuda.CSRC / "hopper.cuh").read_text())
    for banned in ("atomicAdd", "atomicCAS", "atomicExch", "red.global",
                   "red.async", "atom.", "ld.acquire"):
        assert banned not in code + hopper, banned


def test_the_attention_forward_is_tma_wgmma_and_mbarriers():
    """The bf16 attention forward's Hopper kernel loads Q, K and V by TMA
    through an mbarrier ring, multiplies with warpgroup MMAs (SS for the
    scores, RS with P in registers for P·V), rebalances registers with
    setmaxnreg and stores O by TMA, from the shared Hopper helpers; its
    source builds on its own."""
    src = (_cuda.CSRC / "flash_attention_fwd_wgmma.cu").read_text()
    hopper = (_cuda.CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    for call in ("tma_load_4d", "tma_store_4d", "encode_4d", "mbar_init",
                 "mbar_expect_tx", "mbar_wait", "mbar_arrive", "wgmma_ss_n64",
                 "wgmma_ss_n16", "wgmma_rs_dp", "wgmma_fence", "wgmma_commit",
                 "wgmma_wait", "setmaxnreg", "fence.proxy.async",
                 "exp2_approx", "bind_context"):
        assert call in src, call
    for ptx in ("cp.async.bulk.tensor.4d.shared::cluster.global",
                "cp.async.bulk.tensor.4d.global.shared::cta",
                "mbarrier.try_wait.parity", "mbarrier.arrive.expect_tx",
                "wgmma.mma_async.sync.aligned.m64n64k16",
                "wgmma.mma_async.sync.aligned.m64n16k16",
                "wgmma.mma_async.sync.aligned.m64n96k16", "ex2.approx"):
        assert ptx in hopper, ptx
    assert "flash_attention_fwd_wgmma" in _cuda.SOURCES
    assert "flash_attention_fwd_wgmma" in _cuda._SIGNATURES


def test_the_attention_kernels_take_llamas_head_dim_on_wgmma():
    """LLaMA's d = 128 runs both TMA + wgmma attention kernels at DP = 128:
    ``hopper.cuh`` has the m64n128k16 forms the P·V, dV, dK and dQ
    products take (shared-memory A with scale_d; register A), and both
    dispatches refuse any other N at compile time; the forward launches a
    DP = 128 instantiation with one consumer warpgroup a block, the
    backward one whose dV and dQ products run on a warpgroup of their own,
    handed Pᵀ and dSᵀ through shared memory on mbarriers."""
    hopper = (_cuda.CSRC / "hopper.cuh").read_text()
    for form in ("wgmma_ss_n128", "wgmma_rs_n128", "check_setmaxnreg"):
        assert f" {form}(" in hopper, form
    assert hopper.count('"wgmma.mma_async.sync.aligned.m64n128k16') == 3
    assert hopper.count(
        'static_assert(DP == 64 || DP == 96 || DP == 128') == 2
    fwd = (_cuda.CSRC / "flash_attention_fwd_wgmma.cu").read_text()
    assert "return launch<128, 1>(maps, p, st);" in fwd
    assert "D > 128" in fwd and "launch<128, 3>" not in fwd
    assert "cudaOccupancyMaxActiveBlocksPerMultiprocessor" in fwd
    bwd = (_cuda.CSRC / "flash_attention_bwd_wgmma.cu").read_text()
    assert "launch_dp<128>(maps, p, st)" in bwd and "D > 128" in bwd
    for name in ("ds_full", "ds_empty", "P_OFF", "load_bias_t"):
        assert name in bwd, name
    for banned in ("atomicAdd", "atom.", "red.global"):
        assert banned not in fwd + bwd, banned


def test_the_decode_kernel_is_tma_cluster_and_has_no_atomics():
    """The decode kernel streams W by TMA through an mbarrier ring, builds
    its swap-AB fragments with ldmatrix for mma.sync, and sums its K
    splits across a thread-block cluster through distributed shared memory
    in rank order: no atomics, no workspace, no second launch.  Its source
    builds on its own and names the TPU kernels it replaces."""
    src = (_cuda.CSRC / "matmul_decode.cu").read_text()
    assert '#include "hopper.cuh"' in src
    # the cluster's barrier and remote stores are hopper.cuh's helpers
    hopper = (_cuda.CSRC / "hopper.cuh").read_text()
    for call in ("cluster_sync()", "cluster_rank()", "st_cluster_v4("):
        assert call in src, call
    for call in ("tma_load", "encode_2d", "mbar_init", "mbar_expect_tx",
                 "mbar_wait", "mbar_arrive", "bind_context",
                 "ldmatrix.sync.aligned.m8n8.x4.trans",
                 "mma.sync.aligned.m16n8k16", "barrier.cluster.arrive",
                 "mapa.shared::cluster", "st.shared::cluster",
                 "cudaLaunchAttributeClusterDimension", "cudaLaunchKernelEx",
                 "vlm_compression_tpu/ops/masked_linear.py:194",
                 "vlm_compression_tpu/ops/quant.py:84"):
        assert call in src + hopper, call
    for banned in ("atomicAdd", "atom.", "red.global", "splitk_reduce"):
        assert banned not in src + hopper, banned
    assert "matmul_decode" in _cuda.SOURCES
    assert "matmul_decode" in _cuda._SIGNATURES


def test_the_hopper_loop_splits_k_over_a_cluster_and_takes_int8():
    """The Hopper loop's split-K form sums its partials across a
    thread-block cluster through distributed shared memory (no atomics, no
    workspace, no second launch); its int8 form stages the codes by TMA
    and converts them in the transform warpgroup, the scale in the
    epilogue.  The int8 entry point is a source of its own, built in
    parallel, and names the TPU kernel it replaces."""
    loop = (_cuda.CSRC / "wgmma_tile.cuh").read_text()
    hopper = (_cuda.CSRC / "hopper.cuh").read_text()
    for call in ("cluster_sync()", "st_cluster_v4(", "CODE_OFF",
                 "convert_codes", "__byte_perm", "s_scale",
                 "cudaLaunchAttributeClusterDimension", "cudaLaunchKernelEx"):
        assert call in loop, call
    for banned in ("atomicAdd", "atom.", "red.global", "splitk_reduce"):
        assert banned not in loop + hopper, banned
    src = (_cuda.CSRC / "int8_matmul_wgmma.cu").read_text()
    assert '#include "wgmma_tile.cuh"' in src
    assert "vlm_compression_tpu/ops/quant.py:84" in src
    assert "int8_matmul_wgmma" in _cuda.SOURCES
    assert "int8_matmul_wgmma" in _cuda._SIGNATURES


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("impl", [None, TA.WGMMA, TA.MMA])
def test_forward_wrappers_raise_instead_of_falling_back(grad, impl):
    """At a shape the TMA + wgmma forward takes (the ViT's), and with
    either bf16 route forced, the forward wrapper refuses a device the
    kernels do not serve, alone and under autograd: no launch is counted
    on either route."""
    q = torch.empty(2, 257, 16, 88, dtype=torch.bfloat16, device="meta",
                    requires_grad=grad)
    assert TA.plan_forward(257, 257, 88) == TA.WGMMA
    counts = (TA.launches, TA.fwd_wgmma_launches)
    with pytest.raises(ValueError, match="unsupported device"):
        TA.flash_attention(q, q, q, (), 88 ** -0.5, _impl=impl)
    with torch.set_grad_enabled(grad), \
            pytest.raises(ValueError, match="unsupported device"):
        TA.attention_core(q, q, q, scale=88 ** -0.5)
    assert (TA.launches, TA.fwd_wgmma_launches) == counts


def test_forward_without_its_library_raises(monkeypatch, tmp_path):
    """The TMA + wgmma forward (and the mma.sync one, forced) on a tensor
    the kernels serve, with its library not built and no nvcc to build it:
    the wrapper raises; it does not fall back to the plain version, and
    counts no launch."""
    import torch.utils.cpp_extension as cpp

    monkeypatch.setenv("VCT_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(_cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(TA, "_on_card", lambda t: True)
    q = torch.zeros(2, 257, 4, 88, dtype=torch.bfloat16)
    counts = (TA.launches, TA.fwd_wgmma_launches)
    for impl in (None, TA.MMA):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            TA.flash_attention(q, q, q, (), 88 ** -0.5, _impl=impl)
    assert (TA.launches, TA.fwd_wgmma_launches) == counts


# the JAX package's pruners the port does not register yet: none
NOT_PORTED_PRUNERS = set()


def test_pruner_registry_is_the_jax_one_minus_the_listed_names():
    """A pruner ported or dropped without the list above changing fails
    here; ``load_pruner`` builds every registered name."""
    from vlm_compression_tpu.common.registry import registry as jax_registry
    import vlm_compression_tpu.compression  # noqa: F401  (registers)

    from vlm_compression_tpu_torch.common.registry import registry
    from vlm_compression_tpu_torch.compression import load_pruner

    jax_names = set(jax_registry.list_names("pruner"))
    assert len(jax_names) == 23 and NOT_PORTED_PRUNERS <= jax_names
    ported = set(registry.mapping["pruner_name_mapping"])
    assert ported == jax_names - NOT_PORTED_PRUNERS
    model = torch.nn.Linear(2, 2)
    for name in sorted(ported):
        pruner = load_pruner(name, model, [], t5_prune_spec="1-0.5-1.0-1.0")
        assert pruner.pruner_name == name
