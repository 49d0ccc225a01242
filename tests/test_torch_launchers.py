"""The port's launchers (``scripts/torch_trte_dncnn/{train,test}.py``,
``scripts/torch_trte_net/{train,test}.py``) against the JAX package's
(``scripts/trte_*/``), on the CPU.

Each launcher's ``main`` runs a tiny staged config (``{base, grids}``,
written to a temporary ``.cfg``; the JAX launchers read theirs through
``cache.train_stages.run``, which the test points at the same file) in a
temporary working directory, the port's with ``device="cpu"``: here a
4-layer DnCNN at 32x32 (3 frames), trained one epoch and served;
``tests/test_torch_launchers_fastdvdnet.py`` does FastDVDnet. Both packages start from one msgpack checkpoint written
by the JAX package's writer, and the datasets' noise is drawn as JAX draws
it (``tests/test_torch_trainer_eval.py``). Held: ``val_psnr`` (train) and
every frame's PSNR (test) within 1e-3 dB of JAX's; training moves
``val_psnr`` at least ``MOVE_DB`` from the same config at learning rate 0
in both packages (the port's zero-rate run standing for both: it lies
within 1e-5 dB of JAX's), so that a launcher applying no update fails the
1e-3 dB hold; the records' uuids equal
JAX's; the port's cache under ``.cache_f2f_torch/<proj>/``, JAX's under
``.cache_f2f/<proj>/``; a second ``main`` skips every config.

Also: no new launcher imports JAX or ``frame2frame_tpu``
(``scripts/torch_*.py``, ``scripts/torch_*/*.py``), checked on their
source as ``tests/test_torch_guards.py`` checks the package.
"""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from frame2frame_tpu import cache as jcache  # noqa: E402
from frame2frame_tpu.models import serialization as jser  # noqa: E402
from frame2frame_tpu_torch.data import noise as tnoise  # noqa: E402
from frame2frame_tpu_torch.models.dncnn import init_dncnn  # noqa: E402
from frame2frame_tpu_torch.models.fastdvdnet import (  # noqa: E402
    init_fastdvdnet)

from test_torch_nls import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parents[1]
PSNR_DB = 1e-3
# how far training must move val_psnr from the zero-rate run: FastDVDnet's
# one epoch at 1e-6 moves it 7.3e-3 dB, the DnCNN's at 1e-4 more
MOVE_DB = 5 * PSNR_DB
DATA = dict(dname="synthetic", nvideos=2, ntype="g", seed=0)
# Adam's learning rate by model (tests/test_torch_launchers_fastdvdnet.py
# says why FastDVDnet's is small)
TRAIN_LR = {"dncnn": 1e-4, "fastdvdnet": 1e-6}


def load_script(rel):
    path = REPO / "scripts" / rel
    spec = importlib.util.spec_from_file_location(
        "launcher_" + rel.replace("/", "_")[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def jax_dataset_draws(monkeypatch):
    def normal(gen, shape, dtype, device):
        key = jax.random.PRNGKey(gen.initial_seed())
        return torch.from_numpy(np.array(
            jax.random.normal(key, tuple(shape), jnp.float32))).to(device)

    monkeypatch.setattr(tnoise, "_normal", normal)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """One seeded checkpoint a model, written by the JAX package's writer."""
    root = tmp_path_factory.mktemp("ckpt")
    _, dn = init_dncnn(5, channels=1, num_layers=4, residual=True,
                       conv_impl="xla")
    _, fdv = init_fastdvdnet(6, channels=1)
    return {"dncnn": jser.save_variables(root / "dncnn4.msgpack", dn),
            "fastdvdnet": jser.save_variables(root / "fdv.msgpack", fdv)}


def model(ckpts, net):
    out = dict(net_name=net, channels=1, pretrained_load=True,
               pretrained_path=str(ckpts[net]))
    if net == "dncnn":
        out.update(num_of_layers=4, residual=True, conv_impl="xla")
    return out


def staged(tmp_path, base, grids, name="tiny"):
    path = tmp_path / f"{name}.cfg"
    path.write_text(json.dumps({"base": base, "grids": grids}))
    return path


def run_both(monkeypatch, tmp_path, rel, cfg_path):
    """The JAX launcher's ``main()`` and the port's ``main(device="cpu")``
    on ``cfg_path`` in ``tmp_path``: (JAX records, port records)."""
    monkeypatch.chdir(tmp_path)
    stages = jcache.train_stages.run
    monkeypatch.setattr(jcache.train_stages, "run", staticmethod(
        lambda path, cache_dir=".cache_f2f", update=True: stages(
            cfg_path, cache_dir)))
    want = load_script(rel).main()
    port = load_script(rel.replace("trte_", "torch_trte_"))
    got = port.main(device="cpu", cfg_path=cfg_path)
    assert [r["uuid"] for r in got] == [r["uuid"] for r in want]
    proj = rel.split("/")[0] + ("_te" if rel.endswith("test.py") else "")
    for rec in got:
        assert "error" not in rec["results"], rec["results"].get("error")
        assert (tmp_path / ".cache_f2f_torch" / proj
                / f"{rec['uuid']}.pkl").exists()
        assert (tmp_path / ".cache_f2f" / proj / f"{rec['uuid']}.pkl").exists()
    # skip-done: a second call runs nothing
    again = port.main(device="cpu", cfg_path=cfg_path)
    for a, g in zip(again, got):
        assert sorted(a["results"]) == sorted(g["results"])
        for k, v in g["results"].items():
            np.testing.assert_equal(a["results"][k], v)
    return want, got


DNCNN_CLIP = dict(nframes_data=3, isize_data=[32, 32])


def train_launcher(ckpts, tmp_path, monkeypatch, net, clip):
    base = dict(model(ckpts, net), **DATA, **clip, crit_name="sup",
                nepochs=1, lr_init=TRAIN_LR[net], scheduler_name="cosa",
                flow=False)
    rel = ("trte_dncnn" if net == "dncnn" else "trte_net") + "/train.py"
    want, got = run_both(monkeypatch, tmp_path, rel,
                         staged(tmp_path, base, [{"sigma": [25]}]))
    still = load_script(rel.replace("trte_", "torch_trte_")).main(
        device="cpu", cfg_path=staged(tmp_path, dict(base, lr_init=0.0),
                                      [{"sigma": [25]}], "still"))
    for g, w, s in zip(got, want, still):
        g, w, s = (r["results"]["val_psnr"] for r in (g, w, s))
        assert abs(g - w) <= PSNR_DB
        assert min(abs(g - s), abs(w - s)) >= MOVE_DB, (g, w, s)


def eval_launcher(ckpts, tmp_path, monkeypatch, net, clip):
    base = dict(model(ckpts, net), **DATA, **clip, dset="te",
                vid_name="vid00", flow=False, save_deno=False)
    rel = ("trte_dncnn" if net == "dncnn" else "trte_net") + "/test.py"
    want, got = run_both(monkeypatch, tmp_path, rel,
                         staged(tmp_path, base, [{"sigma": [25]}]))
    for g, w in zip(got, want):
        gp, wp = (np.concatenate([np.atleast_1d(p) for p in r["results"][
            "psnrs"]]) for r in (g, w))
        assert gp.shape == wp.shape and np.abs(gp - wp).max() <= PSNR_DB


def test_train_launcher_matches_jax(ckpts, tmp_path, monkeypatch):
    train_launcher(ckpts, tmp_path, monkeypatch, "dncnn", DNCNN_CLIP)


def test_test_launcher_matches_jax(ckpts, tmp_path, monkeypatch):
    eval_launcher(ckpts, tmp_path, monkeypatch, "dncnn", DNCNN_CLIP)


LAUNCHERS = sorted(p.relative_to(REPO).as_posix() for p in (
    list((REPO / "scripts").glob("torch_trte_*/*.py"))
    + [REPO / "scripts" / f"torch_{n}.py" for n in (
        "instances_adapt", "noise_sweep", "accuracy_artifact")]))


@pytest.mark.parametrize("rel", LAUNCHERS)
def test_launcher_imports_no_jax(rel):
    tree = ast.parse((REPO / rel).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    bad = {n for n in names if n.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "frame2frame_tpu")}
    assert not bad, (rel, bad)
    assert len(LAUNCHERS) == 7
