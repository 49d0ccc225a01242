"""Guards of the port's boundaries: it never imports JAX, flax or the JAX
package; its kernel wrappers never fall back; its checkpoint reader decodes
flax msgpack files bit for bit."""

import ast
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import flax.serialization as fser  # noqa: E402

from frame2frame_tpu_torch.models.serialization import (  # noqa: E402
    load_variables,
    strip_prefix,
    unpackb,
)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "frame2frame_tpu_torch"
CKPT = REPO / "results" / "dncnn17_s25" / "checkpoint.msgpack"


def test_port_modules_import_no_jax():
    """Every module of the package, imported in a fresh interpreter, leaves
    jax, flax and frame2frame_tpu out of sys.modules."""
    code = """
import importlib, pkgutil, sys
import frame2frame_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "frame2frame_tpu")]
assert not bad, bad
print(len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 30


def test_port_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|frame2frame_tpu)\b",
                     re.MULTILINE)
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) >= 36
    for rel in ("ops/warp.py", "ops/fused_ends.py", "train/flat_step.py",
                "ops/grad.py", "ops/gaussian.py", "ops/interp.py",
                "ops/pyramid.py", "flow/tvl1_inner.py", "flow/tvl1.py",
                "flow/farneback.py", "flow/api.py", "io/flo.py",
                "io/image.py", "config.py", "cli/tvl1flow.py",
                "ops/conv3x3.py", "ops/conv_dw.py", "cli/blind_denoising.py",
                "utils/profiling.py"):
        assert PKG / rel in files, rel
    for f in files:
        assert not pat.search(f.read_text()), f


def test_cuda_sources_stand_alone():
    """The kernels include the CUDA toolkit's headers and their own shared
    header only: no PyTorch header (a build takes seconds), no library of
    finished kernels."""
    sources = sorted((PKG / "csrc").glob("*.cu*"))
    assert [f.name for f in sources] == ["conv3x3.cu", "conv3x3_c64.cuh",
                                         "fused_ends.cu", "fused_stack.cu",
                                         "fused_stack_bwd.cu",
                                         "tvl1_inner.cu"]
    # cooperative_groups.h: the toolkit's header for the barrier across all
    # blocks that the flow's inner loop takes once an iteration; cuda.h: the
    # toolkit's driver types, for the forward's TMA tensor maps
    allowed = {"cuda_bf16.h", "cuda_runtime.h", "stdint.h", "atomic",
               "type_traits", "conv3x3_c64.cuh", "cooperative_groups.h",
               "cuda.h"}
    for f in sources:
        text = f.read_text()
        included = set(re.findall(r'#include\s+[<"]([^>"]+)[>"]', text))
        assert included <= allowed, (f.name, included - allowed)
        code = re.sub(r"//[^\n]*", "", text)  # comments may name them
        assert not re.search(r"cudnn|cublas|cutlass|torch|atomic(Add|CAS)",
                             code, re.IGNORECASE), f.name


def test_kernel_wrappers_never_fall_back():
    """The kernel modules and the flat step have no ``try`` at all, so no
    failed launch can give way to a plain version; every kernel has its
    ``_plain`` twin in its wrapper's module, and a wrapper reaches the plain
    version only behind a test of the tensor's device."""
    from frame2frame_tpu_torch.ops import fused_stack as fs

    trees = {}
    for rel in ("ops/fused_stack.py", "ops/fused_ends.py", "ops/_common.py",
                "train/flat_step.py", "flow/tvl1_inner.py", "flow/tvl1.py",
                "ops/conv3x3.py", "ops/conv_dw.py"):
        trees[rel] = ast.parse((PKG / rel).read_text())
        assert not [n for n in ast.walk(trees[rel])
                    if isinstance(n, ast.Try)], rel
    names = [k.__name__ for k in fs.KERNELS]
    assert len(names) == len(set(names)) == 11
    funcs = {n.name: n for rel in ("ops/fused_stack.py", "ops/fused_ends.py",
                                   "flow/tvl1_inner.py", "ops/conv3x3.py",
                                   "ops/conv_dw.py")
             for n in trees[rel].body if isinstance(n, ast.FunctionDef)}
    for k in fs.KERNELS:
        name = k.__name__
        assert callable(getattr(sys.modules[k.__module__], name + "_plain"))
        calls_plain = [
            n for n in ast.walk(funcs[name]) if isinstance(n, ast.If)
            and "device.type == 'cpu'" in ast.unparse(n.test)
            and (name + "_plain") in ast.unparse(n.body[0])]
        assert len(calls_plain) == 1, name
        body = ast.unparse(funcs[name])
        assert body.count(name + "_plain") == 1, name
        assert body.count(f"{name}.launches += 1") == 1, name


def test_launch_counts_are_written_only_where_a_kernel_launches():
    """A count goes up by one inside its kernel's wrapper and is set to 0 by
    the registry and where it is defined: no other module writes a count, and
    nothing takes from one or adds a remembered number to it."""
    writes = re.compile(r"(\w+)\.launches\s*([-+*/]?=)(?!=)\s*(\S+)")
    found = {}
    for f in sorted(PKG.rglob("*.py")):
        for who, op, what in writes.findall(f.read_text()):
            assert (op, what) in (("+=", "1"), ("=", "0")), (f.name, who, op)
            if op == "+=":
                found.setdefault(f.relative_to(PKG).as_posix(), []).append(who)
    assert found == {
        "ops/fused_stack.py": ["fwd_layer", "fwd_layer_eval",
                               "fwd_layer_train", "bwd_layer"],
        "ops/fused_ends.py": ["first_conv", "last_loss_fwd", "last_loss_bwd",
                              "first_dw"],
        "flow/tvl1_inner.py": ["tvl1_inner_loop"],
        "ops/conv3x3.py": ["conv3x3_fwd"], "ops/conv_dw.py": ["dw_conv3x3"]}
    # a launch that a stream records into a CUDA graph runs nothing
    inner = (PKG / "flow" / "tvl1_inner.py").read_text()
    assert re.search(r"if not torch\.cuda\.is_current_stream_capturing\(\):"
                     r"\s+tvl1_inner_loop\.launches \+= 1", inner)


def test_end_kernels_count_launches_without_the_registry():
    """``ops/fused_ends.py`` and ``flow/tvl1_inner.py`` imported alone,
    before ``ops/fused_stack.py`` and its registry, have their counters; the
    flow solver does not pull in the network's kernels."""
    code = """
import sys
from frame2frame_tpu_torch.ops import fused_ends as fe
from frame2frame_tpu_torch.flow import tvl1_inner, tvl1, api
assert "frame2frame_tpu_torch.ops.fused_stack" not in sys.modules
for k in (fe.first_conv, fe.last_loss_fwd, fe.last_loss_bwd, fe.first_dw,
          tvl1_inner.tvl1_inner_loop):
    assert k.launches == 0, k
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_flat_step_reads_no_environment():
    """The port picks no implementation from the environment: neither the
    flat step nor the engine that chooses it names ``os.environ`` or the JAX
    package's ``F2F_FLATSTEP`` switch in its code."""
    for rel in ("train/flat_step.py", "ops/fused_ends.py",
                "flow/tvl1_inner.py", "flow/tvl1.py", "flow/api.py"):
        tree = ast.parse((PKG / rel).read_text())
        names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        assert "os" not in names, rel
    tree = ast.parse((PKG / "train" / "online.py").read_text())
    step = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "make_online_step")
    code = ast.unparse(ast.Module(
        [n for n in step.body if not isinstance(n, ast.Expr)], []))
    assert "environ" not in code and "F2F_" not in code


def test_wrappers_refuse_a_device_without_a_kernel():
    """A tensor that is neither on the CPU nor on a CUDA card raises; it
    does not reach the plain version."""
    from frame2frame_tpu_torch.ops import fused_ends as fe
    from frame2frame_tpu_torch.ops import fused_stack as fs
    from frame2frame_tpu_torch.ops.conv3x3 import conv3x3_fwd
    from frame2frame_tpu_torch.ops.conv_dw import dw_conv3x3

    x = torch.zeros(1, 4, 6, 64, device="meta")
    w = torch.zeros(3, 3, 64, 64, device="meta")
    v = torch.zeros(64, device="meta")
    vecs = torch.zeros(8, 64, device="meta")
    img = torch.zeros(4, 6, device="meta")
    w_in = torch.zeros(3, 3, 1, 64, device="meta")
    w_out = torch.zeros(3, 3, 64, 1, device="meta")
    for call in (lambda: fs.fwd_layer(x, w, v, v),
                 lambda: fs.fwd_layer_train(x, w, v, v),
                 lambda: fs.fwd_layer_eval(x, w, v, v),
                 lambda: fs.bwd_layer(x, x, x, w, vecs),
                 lambda: fe.first_conv(img, w_in),
                 lambda: fe.last_loss_fwd(x, v, v, w_out, img, img),
                 lambda: fe.last_loss_bwd(img, img, img, x, w_out, vecs[:4]),
                 lambda: fe.first_dw(x, x, img),
                 lambda: conv3x3_fwd(x, w),
                 lambda: dw_conv3x3(x, x)):
        with pytest.raises(ValueError, match="no kernel for meta"):
            call()
    assert not any(fs.launch_counts().values())


# the library's convolutions, by the names the port could reach them
LIBRARY_CONVS = ("F.conv2d", "torch.conv2d", "functional.conv2d",
                 "nn.grad.conv2d_weight", "nn.grad.conv2d_input",
                 "aten.convolution", "F.conv_transpose2d", "cudnn_convolution")


def _parents(tree):
    return {child: node for node in ast.walk(tree)
            for child in ast.iter_child_nodes(node)}


def _library_conv_calls(tree):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and any(ast.unparse(n.func).endswith(name)
                    for name in LIBRARY_CONVS)]


def test_f32_convolutions_turn_tf32_off():
    """PyTorch lets cuDNN run an f32 convolution in TF32 unless the caller
    turned it off; the JAX package computes in f32. A CPU run cannot see
    TF32, so the sources are held to the rule instead: the port calls the
    library's convolutions in ``ops/_common.py`` only, each inside ``with
    _cudnn_f32():``; the DnCNN module never calls its ``nn.Conv2d``
    holders; ``chip_smoke.py`` times its library yardsticks inside the same
    context (``no_tf32``) and sets no global TF32 flag."""
    for f in sorted(PKG.rglob("*.py")):
        tree = ast.parse(f.read_text())
        calls = _library_conv_calls(tree)
        if f.name != "_common.py" or f.parent.name != "ops":
            assert not calls, (f.name, [ast.unparse(c) for c in calls])
            continue
        assert len(calls) == 3
        parents = _parents(tree)
        for call in calls:
            node = call
            while not isinstance(node, ast.With):
                node = parents[node]
            assert ast.unparse(node.items[0].context_expr) == "_cudnn_f32()"
    dncnn = ast.parse((PKG / "models" / "dncnn.py").read_text())
    assert not [n for n in ast.walk(dncnn) if isinstance(n, ast.Call)
                and re.fullmatch(r"self\.conv_\w+", ast.unparse(n.func))]
    smoke_src = (REPO / "chip_smoke.py").read_text()
    assert "allow_tf32 =" not in smoke_src
    smoke = ast.parse(smoke_src)
    parents = _parents(smoke)
    calls = _library_conv_calls(smoke)
    assert len(calls) >= 4
    for call in calls:
        node, inside = call, False
        while node in parents and not inside:
            node = parents[node]
            inside = (isinstance(node, ast.Call)
                      and ast.unparse(node.func) == "no_tf32")
        assert inside, ast.unparse(call)
    from frame2frame_tpu_torch.ops import _common

    before = torch.backends.cudnn.allow_tf32
    with _common._cudnn_f32():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == before


def test_library_conv_backward_runs_without_tf32(monkeypatch):
    """Autograd runs a backward after the forward's context has ended: the
    port's ``conv2d`` computes its dX and dW inside the context too."""
    from frame2frame_tpu_torch.ops import _common

    seen = []
    for name in ("conv2d_input", "conv2d_weight"):
        real = getattr(torch.nn.grad, name)

        def spy(*a, _real=real, **k):
            seen.append(torch.backends.cudnn.allow_tf32)
            return _real(*a, **k)

        monkeypatch.setattr(torch.nn.grad, name, spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    x = torch.randn(1, 3, 6, 7, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    _common.conv2d(x, w).square().sum().backward()
    assert seen == [False, False]
    assert torch.backends.cudnn.allow_tf32 is True


def test_flow_entry_points_need_a_card_or_the_cpu_by_name():
    """``make_tvl1_solver``, ``AsyncFlowSolver`` and ``run_flows`` run on the
    card unless the caller names the CPU: without a card and without
    ``device="cpu"`` they raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from frame2frame_tpu_torch.flow.api import run_flows
    from frame2frame_tpu_torch.flow.tvl1 import (DENOISING_PARAMS,
                                                 make_batched_tvl1,
                                                 make_tvl1_solver, tvl1_flow)
    from frame2frame_tpu_torch.train.online import AsyncFlowSolver

    img = np.zeros((24, 30), np.float32)
    for call in (lambda: make_tvl1_solver(30, 24),
                 lambda: make_batched_tvl1(30, 24),
                 lambda: tvl1_flow(img, img),
                 lambda: AsyncFlowSolver(30, 24, DENOISING_PARAMS),
                 lambda: run_flows(np.zeros((2, 24, 30), np.float32))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert callable(make_tvl1_solver(30, 24, device="cpu"))
    AsyncFlowSolver(30, 24, DENOISING_PARAMS, device="cpu").close()


def test_farneback_imports_no_jax_and_needs_a_card_or_the_cpu_by_name():
    """``flow/farneback.py`` imported alone leaves jax, flax and the JAX
    package out of ``sys.modules``; its solvers, and ``run_flows`` with
    ``ftype="cv2"``, raise without a card unless ``device="cpu"`` is
    passed."""
    code = """
import sys
import frame2frame_tpu_torch.flow.farneback
bad = [k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "frame2frame_tpu")]
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from frame2frame_tpu_torch.flow.api import run_flows
    from frame2frame_tpu_torch.flow.farneback import (make_batched_farneback,
                                                      make_farneback_solver)

    vid = np.zeros((2, 24, 30), np.float32)
    for call in (lambda: make_farneback_solver(30, 24),
                 lambda: make_batched_farneback(30, 24),
                 lambda: run_flows(vid, ftype="cv2", levels=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    flow = make_farneback_solver(30, 24, levels=1, device="cpu")(vid[0],
                                                                 vid[1])
    assert flow.shape == (24, 30, 2) and flow.device.type == "cpu"
    assert run_flows(vid, ftype="cv2", levels=1, device="cpu").fflow.shape \
        == (1, 2, 24, 30, 2)


def test_flow_solver_has_no_implementation_switch():
    """The tensor's device picks kernel or plain version: the JAX package's
    ``inner_impl=`` and ``vmem_fits`` are not carried over."""
    import inspect

    from frame2frame_tpu_torch.flow import tvl1, tvl1_inner

    assert "inner_impl" not in inspect.signature(tvl1.make_tvl1_solver).parameters
    assert not hasattr(tvl1_inner, "vmem_fits")
    with pytest.raises(TypeError):
        tvl1.make_tvl1_solver(30, 24, device="cpu", inner_impl="pallas")


@pytest.mark.parametrize("why", ["channels", "features", "convention"])
def test_ineligible_model_takes_the_per_iteration_route(monkeypatch, why):
    """Where ``eligible`` is false the engine runs the per-iteration body on
    ``fused_train_apply`` (or the plain module), never ``run_flat_scan``;
    ``flat_step=True`` raises instead."""
    from frame2frame_tpu_torch.models.dncnn import DnCNN, to_jax_variables
    from frame2frame_tpu_torch.train import flat_step
    from frame2frame_tpu_torch.train import online

    kw = {"channels": {"channels": 3}, "features": {"features": 32},
          "convention": {}}[why]
    model = DnCNN(num_layers=4, **kw)
    residual_model = why == "convention"  # the model itself returns noise
    c = model.channels
    rng = np.random.default_rng(5)
    cur, prev = rng.random((2, 6, 8, c)).astype(np.float32)
    flow = np.zeros((6, 8, 2), np.float32)
    assert not flat_step.eligible(model, cur.shape, residual_model)

    def no_flat(*a, **k):
        raise AssertionError("run_flat_scan on an ineligible model")

    monkeypatch.setattr(online, "run_flat_scan", no_flat)
    variables = to_jax_variables(model)
    eng = online.OnlineDenoiser(model, variables, iters=2, device="cpu",
                                residual_model=residual_model)
    deno, losses = eng.process_frame(cur, prev, flow)
    assert deno.shape == cur.shape and losses.shape == (2,)
    forced = online.OnlineDenoiser(model, variables, iters=2, device="cpu",
                                   residual_model=residual_model,
                                   flat_step=True)
    with pytest.raises(ValueError, match="flat_step=True"):
        forced.process_frame(cur, prev, flow)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _assert_same_tree(got, want):
    got_leaves = dict(_leaves(got))
    want_leaves = dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for path, w in want_leaves.items():
        g = got_leaves[path]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray), path
            assert g.dtype == w.dtype and g.shape == w.shape, path
            assert g.tobytes() == w.tobytes(), path
        else:
            assert type(g) is type(w) and g == w, path


def test_load_variables_bit_equal_to_flax_on_checkpoint():
    got = load_variables(CKPT)
    want = fser.msgpack_restore(CKPT.read_bytes())
    _assert_same_tree(got, want)
    assert got["params"]["conv_0"]["kernel"].shape == (3, 3, 64, 64)


def test_unpackb_matches_flax_on_assorted_types():
    tree = {
        "arr": np.arange(12, dtype=np.int64).reshape(3, 4),
        "f16": np.linspace(-1, 1, 5, dtype=np.float16),
        "scalar": np.float32(3.5),
        "nested": {"neg": -3, "neg8": -100, "big": 2**40, "u16": 60000,
                   "f": 0.25, "s": "x" * 40, "t": True, "none": None,
                   "long": list(range(20))},
        "bytes": b"\x00\x01" * 200,
    }
    data = fser.msgpack_serialize(tree)
    _assert_same_tree(unpackb(data), fser.msgpack_restore(data))
    with pytest.raises(ValueError):
        unpackb(data + b"\x00")
    with pytest.raises(ValueError):
        unpackb(data[:-3])


def test_strip_prefix():
    sd = {"net.dncnn.0.weight": 1, "dncnn.1.bias": 2}
    assert strip_prefix(sd) == {"dncnn.0.weight": 1, "dncnn.1.bias": 2}


def test_kernel_library_is_named_by_its_source(tmp_path, monkeypatch):
    """An edited CUDA source gets a new library name, so a stale build in
    build/ is never loaded for it."""
    from frame2frame_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = _build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    second = _build.library_path("k")
    assert first != second
    # so does a source whose shared header was edited
    (tmp_path / "common.cuh").write_text("// header\n")
    third = _build.library_path("k")
    assert third not in (first, second)
    assert _build.sources() == ["k"]
    assert first.parent == second.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR == REPO / "build"
