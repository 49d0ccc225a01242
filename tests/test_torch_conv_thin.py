"""The thin class of kernels A and B (``csrc/conv3x3.cu``: f32 operands with
at most ``THIN_N`` channels on one side, DnCNN's first and last layers) as
its three bodies form the arithmetic, against the port's plain versions and
the JAX package's Pallas kernels ``conv3x3_nopad`` and ``_dw_nopad`` in
interpret mode; and the one rule that says which body runs (``conv_body``),
which the wrappers' alignment checks read.

The bodies run only on the card; ``chip_smoke.py`` holds them to the plain
versions there. What is held here is the order of their arithmetic:

- A at 64 -> n (``a_thin_out``): each pixel's nine tap dots q[p, t, o] =
  sum_c x[p, c] W[t, c, o], zero for pixels outside the image, then y[p] =
  sum_t q[p + off_t, t] in tap order;
- A at n -> 64 (``a_thin_in``): per pixel the nine taps summed in tap order;
- B (``b_thin``): per block the f32 sums over its runs of 16 pixels, the
  blocks' partial rows added in block order in double (``finish_sums``)."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu.ops import pallas_conv as jpc  # noqa: E402
from frame2frame_tpu_torch.ops import conv3x3 as tc  # noqa: E402
from frame2frame_tpu_torch.ops import conv_dw as tdw  # noqa: E402

CU = (Path(__file__).resolve().parents[1] / "frame2frame_tpu_torch" / "csrc"
      / "conv3x3.cu")
# the kernels' forms against the plain versions: the same f32 products,
# summed in another order (chip_smoke.py's bound on the card)
PLAIN_RTOL = 1e-5
# against the Pallas kernels: tests/test_torch_conv3x3.py's bounds
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
T_RUN = 16  # pixels of a row that a slot of b_thin walks
GRID = 5    # blocks of the B form (the card's grid is its resident blocks)

CHANNELS = [(1, 64), (64, 1), (3, 64), (64, 3)]
SIZES = [(13, 21), (16, 24)]
CASES = [(B, h, w, cin, cout) for h, w in SIZES for cin, cout in CHANNELS
         for B in (1, 2)]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def operands(h, w, cin, cout):
    """Two images' x, w, g of one size and channel pair; B = 1 takes the
    first image."""
    rng = np.random.default_rng(h * 1000 + w * 10 + cin + 7 * cout)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout))
          / np.sqrt(9 * cin)).astype(np.float32)
    g = rng.standard_normal((2, h, w, cout)).astype(np.float32)
    return x, wt, g


@pytest.fixture(scope="module")
def jax_refs():
    """(y of both images, dW of image 0, dW of both) of the Pallas kernels
    for each size and channel pair, computed once. Both images go through
    one call as one image of 2 H + 2 rows, two zero rows between them: its
    rows 0 .. H - 1 and H + 2 .. are the images' y, and its dW their sum
    (a tap across the zero rows reads zeros)."""
    out = {}
    for h, w in SIZES:
        for cin, cout in CHANNELS:
            x, wt, g = operands(h, w, cin, cout)
            gap = ((0, 0), (0, 0), (0, 0))
            xs = np.concatenate([x[0], np.pad(x[1], ((2, 0),) + gap[1:])])
            gs = np.concatenate([g[0], np.pad(g[1], ((2, 0),) + gap[1:])])
            pad = ((1, 1), (1, 1), (0, 0))
            y = np.asarray(jpc.conv3x3_nopad(jnp.pad(jnp.asarray(xs), pad),
                                             jnp.asarray(wt)))
            dw0 = np.asarray(jpc._dw_nopad(jnp.pad(jnp.asarray(x[0]), pad),
                                           jnp.asarray(g[0])))
            dw = np.asarray(jpc._dw_nopad(jnp.pad(jnp.asarray(xs), pad),
                                          jnp.asarray(gs)))
            out[h, w, cin, cout] = np.stack([y[:h], y[h + 2:]]), dw0, dw
    return out


def taps(a):
    """The nine (dy, dx) shifts of a zero-padded (B, H, W, C) tensor, tap
    order: [a[:, h + dy - 1, w + dx - 1] for dy, dx]."""
    H, W = a.shape[1:3]
    ap = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
    return [ap[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)]


def a_out_form(x, w, border=0.0):
    """A at 64 -> n as ``a_thin_out`` forms it: q[p, t, o] for every pixel,
    then y[p] = sum_t q[p + off_t, t, o] in tap order. ``border``: the q of
    pixels outside the image (the body's is 0; anything else is a wrong
    formulation)."""
    H, W = x.shape[1:3]
    q = torch.einsum("bhwc,tco->bhwto", x, w.reshape(9, *w.shape[2:]))
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 1, 1, 1, 1), value=border)
    y = None
    for k in range(9):
        dy, dx = divmod(k, 3)
        term = qp[:, dy:dy + H, dx:dx + W, k]
        y = term if y is None else y + term
    return y


def a_in_form(x, w):
    """A at n -> 64 as ``a_thin_in`` forms it: per pixel the nine taps in
    tap order, each over the n input channels."""
    y = None
    for k, xs in enumerate(taps(x)):
        term = torch.einsum("bhwc,co->bhwo", xs, w[k // 3, k % 3])
        y = term if y is None else y + term
    return y


def b_form(x, g, slots):
    """dW as ``b_thin`` forms it: runs of T_RUN pixels of a row, run r taken
    by slot r mod (GRID slots) of block (r mod (GRID slots)) // slots; each
    block's f32 sums over its pixels, then the blocks' rows added in block
    order in double (``finish_sums``)."""
    B, H, W = x.shape[:3]
    runs_x = -(-W // T_RUN)
    run = (torch.arange(B * H)[:, None] * runs_x
           + torch.arange(W)[None] // T_RUN).reshape(B, H, W)
    block = (run % (GRID * slots)) // slots
    xs = torch.stack(taps(x), 0)  # (9, B, H, W, Cin)
    total = torch.zeros(9, x.shape[-1], g.shape[-1], dtype=torch.float64)
    for b in range(GRID):
        m = (block == b).to(torch.float32)[..., None]
        part = torch.einsum("tbhwc,bhwo->tco", xs, g * m)  # f32 sums
        total += part.double()
    return total.float().reshape(3, 3, x.shape[-1], g.shape[-1])


def slots_of(cin, cout):
    """b_thin's slots a block: 32 for one narrow channel, else 16."""
    return 32 if min(cin, cout) == 1 else 16


def case_tensors(case):
    B, h, w, cin, cout = case
    x, wt, g = operands(h, w, cin, cout)
    return t(x[:B]), t(wt), t(g[:B])


def close(got, ref, rtol):
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert err <= rtol * scale, (err, scale)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_a_thin_forms_match_plain_and_pallas(case, jax_refs):
    """A's thin forms (64 -> n inside out, n -> 64 per pixel) within 1e-5 of
    the plain version's largest value and within the Pallas kernel's
    bounds of ``conv3x3_nopad``."""
    B, h, w, cin, cout = case
    x, wt, _ = case_tensors(case)
    form = a_in_form(x, wt) if cin <= tdw.THIN_N else a_out_form(x, wt)
    assert form.dtype == torch.float32 and form.shape == (B, h, w, cout)
    close(form, tc.conv3x3_fwd(x, wt), PLAIN_RTOL)
    np.testing.assert_allclose(form.numpy(), jax_refs[h, w, cin, cout][0][:B],
                               **FWD_TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_b_thin_form_matches_plain_and_pallas(case, jax_refs):
    """B's thin form (blocks' f32 partial rows over runs, added in block
    order in double) within 1e-5 of the plain version's largest value and
    within the Pallas kernel's bounds of ``_dw_nopad`` summed over the
    batch."""
    B, h, w, cin, cout = case
    x, _, g = case_tensors(case)
    form = b_form(x, g, slots_of(cin, cout))
    assert form.dtype == torch.float32 and form.shape == (3, 3, cin, cout)
    close(form, tdw.dw_conv3x3(x, g), PLAIN_RTOL)
    np.testing.assert_allclose(form.numpy(),
                               jax_refs[h, w, cin, cout][B],
                               **GRAD_TOL)


@pytest.mark.parametrize("cout", [1, 3])
def test_a_out_form_with_a_wrong_border_is_caught(cout):
    """The inside-out gather must take q = 0 for pixels outside the image:
    the same form taking any other q there (here a constant) is caught by
    the bound the kernel is held to, at the border and nowhere else."""
    x, wt, _ = case_tensors((2, 13, 21, 64, cout))
    ref = tc.conv3x3_fwd(x, wt)
    close(a_out_form(x, wt), ref, PLAIN_RTOL)
    wrong = a_out_form(x, wt, border=float(wt.sum()))
    err, scale = (wrong - ref).abs(), ref.abs().max().item()
    assert err.max().item() > 1e3 * PLAIN_RTOL * scale
    assert err[:, 1:-1, 1:-1].max().item() <= PLAIN_RTOL * scale


def test_b_form_holds_on_another_grid():
    """Another grid adds the same products in other f32 partial sums: the
    same dW within the plain bound, not necessarily the same bits (the
    card's grid is fixed by the device, so its bits are the same every
    run)."""
    x, _, g = case_tensors((2, 16, 24, 1, 64))
    a = b_form(x, g, 32)
    b = b_form(x, g, 7)
    close(a, b, PLAIN_RTOL)


BODY_CASES = [(cin, cout) for cin in (1, 2, 3, 4, 5, 8, 12, 64, 65, 80)
              for cout in (1, 3, 4, 6, 8, 16, 20, 64, 70)]


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_cp_async_reads_follow_the_body_rule(f32):
    """``cp_async_reads`` (what the wrappers refuse misaligned) follows
    ``conv_body``: both operands in the tensor-core bodies; in the thin
    class the wide operand where its rows are whole 16-byte chunks; nothing
    in the FMA bodies."""
    seen = set()
    for cin, cout in BODY_CASES:
        body = tdw.conv_body(f32, cin, cout)
        seen.add(body)
        reads = tdw.cp_async_reads(f32, cin, cout)
        if body == "tensor cores":
            assert reads == (True, True)
        elif body == "thin":
            wide_in = cin > tdw.THIN_N
            assert min(cin, cout) <= tdw.THIN_N
            assert reads == ((wide_in and cin % 4 == 0),
                             (not wide_in and cout % 4 == 0))
        elif body == "FMA":
            assert reads == (False, False)
            assert min(cin, cout) > tdw.THIN_N
        else:
            assert not f32 and reads == (cin % 8 == 0, cout % 8 == 0)
    assert seen == ({"tensor cores", "thin", "FMA"} if f32
                    else {"bf16 tensor cores"})
    assert tdw.cp_async_reads(True, 1, 64) == (False, True)
    assert tdw.cp_async_reads(True, 64, 1) == (True, False)


def test_c_dispatch_takes_the_same_rule():
    """The C source's thin bound is the Python rule's, its ``body_of`` tests
    the tensor cores before the thin class, and both entry points and the
    exported query dispatch through it (the card checks the query against
    ``conv_body`` on 132 channel pairs, ``chip_smoke.py``)."""
    src = CU.read_text()
    assert int(re.search(r"constexpr int THIN_N = (\d+);", src).group(1)) \
        == tdw.THIN_N
    body = re.search(r"int body_of\(int b, int is_f32, int cin, int cout\) "
                     r"\{(.*?)\n\}", src, re.S).group(1)
    assert re.findall(r"return ([A-Z_0-9]+|min[^;]*)", body) == [
        "BODY_BF16", "BODY_TC", "min(cin, cout) <= THIN_N ? BODY_THIN : "
        "BODY_FMA"]
    order = re.search(r"enum Body \{(.*?)\};", src).group(1)
    assert [n.split("=")[0].strip() for n in order.split(",")] == [
        "BODY_FMA", "BODY_TC", "BODY_THIN", "BODY_BF16"]
    assert len(tdw.BODIES) == 4
    for entry, b in (("f2f_conv3x3(", "0, 1"),
                     ("f2f_dw_conv3x3(", "1, is_f32")):
        fn = src.split("int " + entry, 1)[1].split("\n}\n", 1)[0]
        assert f"switch (body_of({b}, Cin, Cout))" in fn, entry
    assert "return body_of(kernel_b, is_f32, cin, cout);" in src
