"""CLI for TV-L1 optical flow, argument-compatible with the reference C binary
(tvl1flow/main.c:73-99): ``tvl1flow I0 I1 [out nproc tau lambda theta nscales
fscale zfactor nwarps epsilon verbose]``. ``nproc`` is accepted and ignored
(an OpenMP thread count means nothing to the card).

Counterpart of ``frame2frame_tpu/cli/tvl1flow.py``. It solves on the CUDA
card and raises where there is none; ``main(argv, device="cpu")`` solves on
the host.
"""

from __future__ import annotations

import sys

import numpy as np

DEFAULTS = dict(out="flow.flo", nproc=4, tau=0.25, lambda_=0.15, theta=0.3,
                nscales=100, fscale=0, zfactor=0.5, nwarps=5, epsilon=0.01,
                verbose=0)


def main(argv=None, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print("Usage: tvl1flow I0 I1 [out nproc tau lambda theta nscales "
              "fscale zfactor nwarps epsilon verbose]", file=sys.stderr)
        return 1

    from ..io.flo import write_flo
    from ..io.image import read_gray
    from ..flow.tvl1 import make_tvl1_solver

    i0_name, i1_name = argv[0], argv[1]
    get = lambda i, cast, dflt: cast(argv[i]) if len(argv) > i else dflt
    out = get(2, str, DEFAULTS["out"])
    _nproc = get(3, int, DEFAULTS["nproc"])
    tau = get(4, float, DEFAULTS["tau"])
    lam = get(5, float, DEFAULTS["lambda_"])
    theta = get(6, float, DEFAULTS["theta"])
    nscales = get(7, int, DEFAULTS["nscales"])
    fscale = get(8, int, DEFAULTS["fscale"])
    zfactor = get(9, float, DEFAULTS["zfactor"])
    nwarps = get(10, int, DEFAULTS["nwarps"])
    epsilon = get(11, float, DEFAULTS["epsilon"])
    verbose = get(12, int, DEFAULTS["verbose"])

    # parameter validation mirroring main.c:101-141
    if tau <= 0 or tau > 0.25:
        tau = DEFAULTS["tau"]
    if lam <= 0:
        lam = DEFAULTS["lambda_"]
    if theta <= 0:
        theta = DEFAULTS["theta"]
    if nscales <= 0:
        nscales = DEFAULTS["nscales"]
    if zfactor <= 0 or zfactor >= 1:
        zfactor = DEFAULTS["zfactor"]
    if nwarps <= 0:
        nwarps = DEFAULTS["nwarps"]
    if epsilon <= 0:
        epsilon = DEFAULTS["epsilon"]

    I0 = np.asarray(read_gray(i0_name), dtype=np.float32)
    I1 = np.asarray(read_gray(i1_name), dtype=np.float32)
    # read_gray returns [0,1] for integer inputs; the C iio reader returned
    # [0,255] — immaterial because the solver normalizes jointly to [0,255]
    if I0.shape != I1.shape:
        print(f"ERROR: input images size mismatch {I0.shape} != {I1.shape}",
              file=sys.stderr)
        return 1

    ny, nx = I0.shape
    solver = make_tvl1_solver(nx, ny, tau=tau, lambda_=lam, theta=theta,
                              nscales=nscales, fscale=fscale, zfactor=zfactor,
                              warps=nwarps, epsilon=epsilon, device=device)
    if verbose:
        print(f"tau={tau} lambda={lam} theta={theta} nscales={nscales} "
              f"zfactor={zfactor} nwarps={nwarps} epsilon={epsilon}",
              file=sys.stderr)
    flow = solver(I0, I1).cpu().numpy()
    write_flo(out, flow)
    return 0


if __name__ == "__main__":
    sys.exit(main())
