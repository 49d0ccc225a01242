"""CLI for model-blind video denoising, argument-compatible with the reference
``blind_denoising.py`` (blind_denoising.py:262-290) and with
``frame2frame_tpu/cli/blind_denoising.py``, whose extra flags it keeps:
``--compute_flow`` (TV-L1 in the pipeline instead of ``.flo`` files),
``--channels`` / ``--layers`` (the network's shape), ``--remat`` and
``--profile``.

Usage (on the CUDA card; it raises where there is none):
    python -m frame2frame_tpu_torch.cli.blind_denoising \\
        --input noisy/%03d.png --flow flows/%03d.flo --ref clean/%03d.png \\
        --output out/%03d.png --first 1 --last 300 --iter 20 \\
        --network results/dncnn17_s25/checkpoint.msgpack

``main(argv, device="cpu")`` runs on the host (the plain versions of the
kernels). Without ``--network`` the DnCNN starts from ``init_dncnn(0)``,
whose values differ from the JAX package's ``PRNGKey(0)`` draw. The model's
``conv_impl`` is ``"fused"``: the engine takes the flat step where it
covers the model.
"""

from __future__ import annotations

import argparse
import sys


def build_parser():
    parser = argparse.ArgumentParser(
        description="Blind_denoising_grayscale (CUDA)")
    parser.add_argument("--input", type=str, default="",
                        help="path to input frames (C type)")
    parser.add_argument("--ref", type=str, default="",
                        help="path to reference frames (C type) for PSNR")
    parser.add_argument("--flow", type=str, default="",
                        help="path to optical flow (C type .flo); empty => "
                        "TV-L1 on the device")
    parser.add_argument("--output", type=str, default="./%03d.png",
                        help="path to output image (C type)")
    parser.add_argument("--output_psnr", type=str, default="plot_psnr.txt")
    parser.add_argument("--output_network", type=str, default="final.msgpack")
    parser.add_argument("--first", type=int, default=1)
    parser.add_argument("--last", type=int, default=300)
    parser.add_argument("--iter", type=int, default=20,
                        help="fine-tune iterations per frame")
    parser.add_argument("--network", type=str, default="",
                        help=".pth or .msgpack checkpoint (empty => random "
                        "init)")
    parser.add_argument("--lr", type=float, default=5e-5)
    parser.add_argument("--weight_decay", type=float, default=1e-5)
    parser.add_argument("--channels", type=int, default=1)
    parser.add_argument("--layers", type=int, default=17)
    parser.add_argument("--compute_flow", action="store_true")
    parser.add_argument("--remat", type=int, default=-1,
                        help="checkpoint every N layers during fine-tune "
                        "(-1 = auto: 2 for frames >= ~1MP, else off)")
    parser.add_argument("--profile", type=str, default="",
                        help="write a torch.profiler Chrome trace "
                        "(trace.json), the program's spans and counters "
                        "(spans.json) and a CUDA memory snapshot into this "
                        "directory")
    return parser


def main(argv=None, device=None):
    args = build_parser().parse_args(argv)

    print("\n### Model-blind Video Denoising Via Frame-to-frame Training "
          "(CUDA) ###")
    print("> Parameters:")
    for p, v in vars(args).items():
        print(f"\t{p}: {v}")
    print()

    from ..io.image import read_frame
    from ..models.dncnn import init_dncnn, load_torch_checkpoint
    from ..models.serialization import load_variables
    from ..train.online import run_blind_denoising
    from ..utils.device import resolve_device
    from ..utils.profiling import trace_if, write_memory_profile

    device = resolve_device(device)
    remat = args.remat
    if remat < 0:  # auto: big frames need activation checkpointing
        probe = read_frame(args.input, args.first)
        remat = 2 if probe.shape[0] * probe.shape[1] >= 1_000_000 else 0

    model, variables = init_dncnn(0, channels=args.channels,
                                  num_layers=args.layers, residual=False,
                                  remat_every=remat)
    if not args.network:
        # the reference always starts from a pretrained net
        # (blind_denoising.py:287-288); fine-tuning from random weights
        # usually diverges
        print("warning: no --network checkpoint given — starting from random "
              "init; expect poor/divergent PSNR (pass a DnCNN .pth or "
              ".msgpack)", file=sys.stderr)
    elif args.network.endswith((".pth", ".pt")):
        variables = load_torch_checkpoint(args.network, num_layers=args.layers)
    else:
        tree = load_variables(args.network)
        variables = {"params": tree["params"],
                     "batch_stats": tree["batch_stats"]}

    with trace_if(args.profile):
        results = run_blind_denoising(
            model,
            variables,
            input_tmpl=args.input,
            flow_tmpl=args.flow or None,
            ref_tmpl=args.ref or None,
            output_tmpl=args.output,
            output_psnr=args.output_psnr,
            output_network=args.output_network,
            first=args.first,
            last=args.last,
            iters=args.iter,
            lr=args.lr,
            weight_decay=args.weight_decay,
            compute_flow=args.compute_flow or not args.flow,
            progress=True,
            device=device,
        )
    if args.profile and device.type == "cuda":
        write_memory_profile(args.profile.rstrip("/") + "/device_mem.pickle")
    return results


if __name__ == "__main__":
    main()
