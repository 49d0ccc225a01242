"""A/B timing of the port's kernels against another tree's (the parent
commit's), on one card in one process.

    git archive <parent> | tar -x -C build/parent
    python3 scripts/torch_kernel_ab.py --parent build/parent

Builds ``frame2frame_tpu_torch/csrc/{fused_stack,fused_stack_bwd,conv3x3,
fused_ends,tvl1_inner}.cu`` of both trees with the port's nvcc flags into
``build/ab/``, then times each kernel with CUDA events in turns: parent,
change, change, parent. At 540x960 on bf16 operands: the forward layers,
also on the f32 chain, ``bwd_layer``, kernel B on bf16 and on f32 operands
at 64->64, 1->64 and 64->1 (and 3->64, 64->3 on f32), kernel A on f32 at
the same shapes, and ``last_loss_fwd``, ``last_loss_bwd`` and ``first_dw``
on both chains (every case after a head start of the device, as the thin
layers and the end kernels are shorter than their calls). ``CHANGED``
names the cases whose kernels the change touched (the mid-layer forms,
which took a row window and run their launches without one through the
same body); every other case is a control, printed with its change from
the parent's mean. The flow's inner loop at 135x240 and 68x120 (smooth
synthetic inputs, epsilon 0.01, up to 300 iterations): each tree's own
body, which the change's ``cluster_plan`` picks by shape and the parent
does not have (it has the cooperative body only). ``bwd_layer``'s C
interface changed from two kernels with a dz scratch to one kernel; the
script calls each tree's own. Prints the card line and one JSON object.
Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
SOURCES = ("fused_stack", "fused_stack_bwd", "conv3x3", "fused_ends",
           "tvl1_inner")
FLOW_SHAPES = ((135, 240), (68, 120))
H, W, C = 540, 960, 64
THIN = ((1, C), (C, 1), (3, C), (C, 3))
CHANGED = {"fwd_layer", "fwd_layer_eval", "fwd_layer_train", "bwd_layer",
           "fwd_layer f32", "fwd_layer_eval f32", "fwd_layer_train f32"}


def build(tree, tag, name):
    from frame2frame_tpu_torch.ops import _build

    out = REPO / "build" / "ab" / tag
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib{name}.so"
    src = Path(tree) / "frame2frame_tpu_torch" / "csrc" / f"{name}.cu"
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                          str(so), str(src)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {tag}/{name}.cu:\n{res.stderr}")
    return (tag, name), ctypes.CDLL(str(so))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other tree (a git archive of it)")
    args = ap.parse_args(argv)

    import torch

    from frame2frame_tpu_torch.flow.tvl1_inner import _scalars, cluster_plan
    from frame2frame_tpu_torch.utils.timer import cuda_time_ms

    if not torch.cuda.is_available():
        sys.exit("torch_kernel_ab: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    trees = {"parent": args.parent, "change": str(REPO)}
    with ThreadPoolExecutor(len(trees) * len(SOURCES)) as ex:
        libs = dict(ex.map(lambda a: build(*a), [
            (tree, tag, name) for tag, tree in trees.items()
            for name in SOURCES]))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, device=dev, generator=gen)

    rows = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    z = randn(1, H, W, C).bfloat16()
    zi, g = randn(1, H, W, C).bfloat16(), randn(1, H, W, C, scale=0.1).bfloat16()
    w = randn(3, 3, C, C, scale=0.05).bfloat16()
    s, b = 1 + randn(C, scale=0.2), randn(C, scale=0.1)
    vec = torch.stack([1 + randn(C, scale=0.2), randn(C, scale=0.1),
                       randn(C, scale=1e-3), randn(C, scale=1e-3),
                       1 + randn(C, scale=0.2), randn(C, scale=0.1),
                       0.5 + torch.rand(C, device=dev, generator=gen),
                       randn(C, scale=0.1)])
    out = torch.empty_like(z)
    zf, outf = z.float(), torch.empty_like(z, dtype=torch.float32)
    gf, wf = g.float(), w.float()
    da, dz = torch.empty_like(z), torch.empty_like(z)
    stats = torch.empty(2 * C + 9 * C * C, device=dev)
    part = torch.empty(rows, 2 * C + 9 * C * C, device=dev)
    part_stats = torch.empty(rows, 2 * C, device=dev)
    # last_loss_fwd: z on both chains, the last BatchNorm's affine, the
    # output weights and the loss constants of one frame
    mask = (torch.rand(H, W, device=dev, generator=gen) > 0.1).float()
    aux_c = mask * torch.rand(H, W, device=dev, generator=gen)
    w_out = randn(3, 3, C, 1, scale=0.06)
    noise = torch.empty(H, W, device=dev)
    loss = torch.empty((), device=dev)
    part_loss = torch.empty(rows, device=dev)
    # last_loss_bwd: a forward's noise, the last BatchNorm's four vectors;
    # first_dw: a frame in the chain's dtype
    noise_in = randn(H, W, scale=0.3)
    vec_e = torch.stack([1 + randn(C, scale=0.2), randn(C, scale=0.1),
                         0.5 + torch.rand(C, device=dev, generator=gen),
                         randn(C, scale=0.1)])
    sums_e = torch.empty(11, C, device=dev)
    part_e = torch.empty(rows, 11, C, device=dev)
    x_in = randn(H, W)

    def flow_inputs(ny, nx):
        """The ten arrays of the inner loop, smooth as the solver's are."""
        yy, xx = torch.meshgrid(torch.arange(ny, device=dev),
                                torch.arange(nx, device=dev), indexing="ij")
        yy, xx = yy.float(), xx.float()
        ix = 20 * torch.cos(0.31 * xx + 0.17 * yy)
        iy = 15 * torch.sin(0.23 * yy - 0.05 * xx)
        u1 = 0.6 + 0.2 * torch.randn(ny, nx, device=dev, generator=gen)
        u2 = -0.3 + 0.2 * torch.randn(ny, nx, device=dev, generator=gen)
        rho_c = 3 * torch.sin(0.11 * xx) - ix * u1 - iy * u2
        ps = [0.1 * torch.randn(ny, nx, device=dev, generator=gen)
              for _ in range(4)]
        return [x.contiguous() for x in (ix, iy, rho_c, ix * ix + iy * iy,
                                         u1, u2, *ps)]

    flows = {shape: flow_inputs(*shape) for shape in FLOW_SHAPES}
    l_t, taut, theta, eps2 = _scalars(0.25, 0.2, 0.3, 0.01)

    def calls(tag):
        """{case: function} of one tree's kernels."""
        fs = libs[tag, "fused_stack"]
        for fn in (fs.f2f_fwd_layer, fs.f2f_fwd_layer_eval):
            fn.restype, fn.argtypes = ci, [vp, ci, vp, vp, vp, vp, ci, ci, ci,
                                           vp]
        fs.f2f_fwd_layer_train.restype = ci
        fs.f2f_fwd_layer_train.argtypes = [vp, ci] + [vp] * 6 + [ci] * 4 + [vp]
        bwd = libs[tag, "fused_stack_bwd"].f2f_bwd_layer
        two = tag == "parent" and "dz" in (
            Path(trees[tag]) / "frame2frame_tpu_torch" / "csrc" /
            "fused_stack_bwd.cu").read_text().split("int f2f_bwd_layer(")[1][:400]
        bwd.restype = ci
        bwd.argtypes = ([vp, vp, vp, ci, vp, vp, ci] + [vp] * (6 if two else 3)
                        + [ci] * 4 + [vp])
        dwk = libs[tag, "conv3x3"].f2f_dw_conv3x3
        dwk.restype = ci
        dwk.argtypes = [vp, vp, ci, vp, vp] + [ci] * 6 + [vp]
        ka = libs[tag, "conv3x3"].f2f_conv3x3
        ka.restype = ci
        ka.argtypes = [vp, vp, vp] + [ci] * 5 + [vp]
        p = lambda t: t.data_ptr()  # noqa: E731
        args = (p(z), 0, p(w), p(s), p(b), p(out), 1, H, W, stream)
        args_f32 = (p(zf), 1, p(w), p(s), p(b), p(outf), 1, H, W, stream)
        out_calls = {
            "fwd_layer": lambda: fs.f2f_fwd_layer(*args),
            "fwd_layer_eval": lambda: fs.f2f_fwd_layer_eval(*args),
            "fwd_layer_train": lambda: fs.f2f_fwd_layer_train(
                p(z), 0, p(w), p(s), p(b), p(out), p(stats), p(part_stats),
                rows, 1, H, W, stream),
            "fwd_layer f32": lambda: fs.f2f_fwd_layer(*args_f32),
            "fwd_layer_eval f32": lambda: fs.f2f_fwd_layer_eval(*args_f32),
            "fwd_layer_train f32": lambda: fs.f2f_fwd_layer_train(
                p(zf), 1, p(w), p(s), p(b), p(outf), p(stats), p(part_stats),
                rows, 1, H, W, stream),
            "bwd_layer": (lambda: bwd(
                p(g), p(zi), p(z), 0, p(w), p(vec), 0, p(da), p(dz),
                p(stats[2 * C:]), p(stats), p(part_stats), p(part), rows, 1,
                H, W, stream)) if two else (lambda: bwd(
                    p(g), p(zi), p(z), 0, p(w), p(vec), 0, p(da), p(stats),
                    p(part), rows, 1, H, W, stream))}
        for cin, cout in ((C, C),) + THIN:
            dw = torch.empty(9 * cin * cout, device=dev)
            pdw = torch.empty(rows, 9 * cin * cout, device=dev)
            for f32, (zz, gz) in enumerate(((z, g), (zf, gf))):
                if not f32 and cin * cout == 3 * C:
                    continue  # colour on bf16: no change, no control
                x = zz[..., :cin].contiguous()
                gg = gz[..., :cout].contiguous()
                out_calls[f"dw_conv3x3 {cin}->{cout}" + (" f32" if f32
                                                          else "")] = (
                    lambda x=x, gg=gg, dw=dw, pdw=pdw, cin=cin, cout=cout,
                    f32=f32: dwk(p(x), p(gg), f32, p(dw), p(pdw), rows, 1, H,
                                 W, cin, cout, stream))
            x = zf[..., :cin].contiguous()
            wc = wf[:, :, :cin, :cout].contiguous()
            y = torch.empty(1, H, W, cout, device=dev)
            out_calls[f"conv3x3 {cin}->{cout} f32"] = (
                lambda x=x, wc=wc, y=y, cin=cin, cout=cout: ka(
                    p(x), p(wc), p(y), 1, H, W, cin, cout, stream))
        fe = libs[tag, "fused_ends"].f2f_last_loss_fwd
        fe.restype = ci
        fe.argtypes = [vp, ci] + [vp] * 8 + [ci] * 3 + [vp]
        lib = libs[tag, "fused_ends"]
        lib.f2f_last_loss_bwd.restype = lib.f2f_first_dw.restype = ci
        lib.f2f_last_loss_bwd.argtypes = ([vp] * 4 + [ci] + [vp] * 5
                                          + [ci] * 3 + [vp])
        lib.f2f_first_dw.argtypes = [vp] * 3 + [ci] + [vp] * 2 + [ci] * 3 + [vp]
        for f32, (zz, oo, gz) in enumerate(((z, out, g), (zf, outf, gf))):
            sfx = " f32" if f32 else ""
            xx = x_in.to(zz.dtype)
            out_calls["last_loss_fwd" + sfx] = (
                lambda zz=zz, f32=f32: fe(
                    p(zz), f32, p(s), p(b), p(w_out), p(aux_c), p(mask),
                    p(noise), p(loss), p(part_loss), rows, H, W, stream))
            out_calls["last_loss_bwd" + sfx] = (
                lambda zz=zz, oo=oo, f32=f32: lib.f2f_last_loss_bwd(
                    p(noise_in), p(aux_c), p(mask), p(zz), f32, p(w_out),
                    p(vec_e), p(oo), p(sums_e), p(part_e), rows, H, W,
                    stream))
            out_calls["first_dw" + sfx] = (
                lambda zz=zz, gz=gz, xx=xx, f32=f32: lib.f2f_first_dw(
                    p(gz), p(zz), p(xx), f32, p(sums_e), p(part_e), rows, H,
                    W, stream))
        tv = libs[tag, "tvl1_inner"]
        tv.f2f_tvl1_inner.restype = ci
        tv.f2f_tvl1_inner.argtypes = [vp] * 6 + [ci] * 3 + [cf] * 4 + [ci, vp]
        has_cluster = hasattr(tv, "f2f_tvl1_cluster")
        if has_cluster:
            tv.f2f_tvl1_cluster.restype = ci
            tv.f2f_tvl1_cluster.argtypes = ([vp] * 4 + [ci] * 5 + [cf] * 4
                                            + [ci, vp])
            tv.f2f_tvl1_cluster_check.restype = ci
            tv.f2f_tvl1_cluster_check.argtypes = [ci, ci]
        for (ny, nx), arrays in flows.items():
            ptrs = lambda xs: (vp * len(xs))(*(x.data_ptr() for x in xs))  # noqa: E731
            fout = [torch.empty(ny, nx, device=dev) for _ in range(6)]
            ftmp = [torch.empty(ny, nx, device=dev) for _ in range(6)]
            tiles = -(-ny // 8) * -(-nx // 32)
            partial = torch.empty(2, tiles, dtype=torch.float64, device=dev)
            stats_f = torch.empty(1, 2, device=dev)
            plan = cluster_plan(ny, nx) if has_cluster else None
            fixed, state, outs = (ptrs(arrays[:4]), ptrs(arrays[4:]),
                                  ptrs(fout))
            if plan:
                # the shape is allowed and checked once before its launches,
                # as the wrapper does
                rc = tv.f2f_tvl1_cluster_check(plan[0], plan[1])
                if rc:
                    raise RuntimeError(f"cluster refused: cudaError {rc}")
                call = (lambda fixed=fixed, state=state, outs=outs,
                        stats_f=stats_f, ny=ny, nx=nx, plan=plan:
                        tv.f2f_tvl1_cluster(
                            fixed, state, outs, p(stats_f), 1, ny, nx,
                            plan[0], plan[1], l_t, taut, theta, eps2, 300,
                            stream))
            else:
                call = (lambda fixed=fixed, state=state, outs=outs,
                        tmpp=ptrs(ftmp), partial=partial, stats_f=stats_f,
                        ny=ny, nx=nx: tv.f2f_tvl1_inner(
                            fixed, state, outs, tmpp, p(partial), p(stats_f),
                            1, ny, nx, l_t, taut, theta, eps2, 300, stream))
            out_calls[f"tvl1_inner_loop {ny}x{nx}"] = call
        return out_calls

    by_tag = {tag: calls(tag) for tag in trees}

    def timed(fn):
        def run():
            rc = fn()
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
        return cuda_time_ms(run, iters=50, head_start_cycles=5_000_000)

    result = {"card": card, "hw": [H, W], "changed": sorted(CHANGED),
              "ms": {}}
    for case in by_tag["change"]:
        order = ("parent", "change", "change", "parent")
        times = [timed(by_tag[tag][case]) for tag in order]
        result["ms"][case] = {"parent": [times[0], times[3]],
                              "change": [times[1], times[2]]}
        move = (times[1] + times[2]) / (times[0] + times[3]) - 1
        role = "change" if case in CHANGED else f"control {100 * move:+.1f} %"
        print(f"{case}: parent {times[0]:.4f} {times[3]:.4f} change "
              f"{times[1]:.4f} {times[2]:.4f} ms ({role})", flush=True)
    print(card)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
