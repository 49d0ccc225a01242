"""The port's experiment cache and dispatch backends
(``frame2frame_tpu_torch/cache/``) against the JAX package's
(``frame2frame_tpu/cache/``), on the CPU.

- the same uuid for the same config, and the same cache layout: the
  ``<proj>/<uuid>.pkl`` records and ``.json`` sidecars hold what JAX's hold;
  ``train_stages.run`` on ``exps/trte_*/*.cfg`` gives JAX's configs and
  uuids;
- skip-done (a second call runs nothing) and ``clear``;
- records: a run that raises is recorded as ``{"error": ...}`` and then
  skipped as done, as in JAX; ``_to_plain`` turns tensors into numpy
  arrays and drops a ``TrainState``; the launchers' ``records_table``
  and ``mean_psnrs`` (``cache/launch.py``) summarise without pandas;
- the local wandb JSONL, line for line JAX's;
- the process backend, three tiny jobs: each ran in another interpreter,
  skip-done across a second dispatch, "slurm" without ``sbatch`` falls back
  to the pool, the job's ``device`` reaches its run function and never its
  config (the uuid does not change), one worker on the CPU by default.
"""

import json
import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from frame2frame_tpu import cache as jcache  # noqa: E402
from frame2frame_tpu.config import cfg_uuid as jax_uuid  # noqa: E402
from frame2frame_tpu_torch import cache  # noqa: E402
from frame2frame_tpu_torch.cache import dispatch  # noqa: E402
from frame2frame_tpu_torch.cache import launch  # noqa: E402
from frame2frame_tpu_torch.config import cfg_uuid  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = [{"net_name": "dncnn", "sigma": 25, "isize_data": [64, 64],
         "lr_init": 1e-3, "flow": False, "tag": "a"},
        {"b": (1, 2), "c": None, "d": {"e": 1.5}}]


def plain_run(cfg):
    return {"value": cfg.get("sigma", 0) * 2, "tag": str(cfg.get("tag"))}


@pytest.fixture
def no_wandb(monkeypatch):
    """wandb never imports here: the local JSONL logger takes the runs."""
    monkeypatch.setitem(sys.modules, "wandb", None)


def test_uuid_matches_jax():
    for cfg in CFGS + cache.load_edata({"a": 1}, {"x": [1, 2], "y": ["u"]}):
        assert cfg_uuid(cfg) == jax_uuid(cfg)
    assert cache.get_uuids(CFGS, None) == jcache.get_uuids(CFGS, None)


@pytest.mark.parametrize("name", ["trte_dncnn/train.cfg",
                                  "trte_dncnn/test.cfg",
                                  "trte_net/train.cfg", "trte_net/test.cfg"])
def test_train_stages_match_jax(name):
    path = os.path.join(REPO, "exps", name)
    exps, uuids = cache.train_stages.run(path)
    jexps, juuids = jcache.train_stages.run(path)
    assert uuids == juuids and [dict(e) for e in exps] == [
        dict(e) for e in jexps]


def test_layout_and_wandb_match_jax(tmp_path, no_wandb):
    exps = cache.load_edata(CFGS[0], {"sigma": [15, 25]})
    recs = cache.run_exps(exps, plain_run, cache_dir=tmp_path / "port",
                          proj_name="p", use_wandb=True, verbose=False)
    jrecs = jcache.run_exps(exps, plain_run, cache_dir=tmp_path / "jax",
                            proj_name="p", use_wandb=True, verbose=False)
    assert recs == jrecs

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file())

    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    for rel in tree(tmp_path / "port"):
        a = (tmp_path / "port" / rel).read_bytes()
        b = (tmp_path / "jax" / rel).read_bytes()
        if rel.endswith(".pkl"):
            assert pickle.loads(a) == pickle.loads(b), rel
        else:
            assert a == b, rel
    logs = sorted((tmp_path / "port" / "wandb" / "p").glob("*.jsonl"))
    assert len(logs) == 2
    lines = [json.loads(ln) for ln in logs[0].read_text().splitlines()]
    assert [ln["event"] for ln in lines] == ["init", "summary"]


def test_skip_done_and_clear(tmp_path):
    calls = []

    def run(cfg):
        calls.append(cfg["x"])
        return {"x": cfg["x"]}

    exps = cache.load_edata({"k": 1}, {"x": [1, 2]})
    for _ in range(2):
        recs = cache.run_exps(exps, run, cache_dir=tmp_path, verbose=False)
    assert calls == [1, 2]
    assert [r["results"]["x"] for r in recs] == [1, 2]
    cache.run_exps(exps, run, cache_dir=tmp_path, clear=True, verbose=False)
    assert calls == [1, 2, 1, 2]
    assert cache.CACHE_DIR == ".cache_f2f_torch"


def test_records_to_plain_and_errors(tmp_path):
    from frame2frame_tpu_torch.models.dncnn import init_dncnn
    from frame2frame_tpu_torch.train.schedules import make_optimizer
    from frame2frame_tpu_torch.train.state import TrainState

    model, variables = init_dncnn(0, channels=1, num_layers=3)
    tx, _ = make_optimizer({"lr_init": 1e-3})
    state = TrainState.create(model, variables, tx)

    def run(cfg):
        if cfg["x"] == 2:
            raise RuntimeError("boom")
        return {"t": torch.arange(3.0), "nested": [torch.ones(2, 2), 1.5],
                "state": state, "a": np.zeros(2), "s": "ok"}

    exps = cache.load_edata({}, {"x": [1, 2]})
    recs = cache.run_exps(exps, run, cache_dir=tmp_path, verbose=False)
    res = recs[0]["results"]
    assert sorted(res) == ["a", "nested", "s", "t"]
    assert isinstance(res["t"], np.ndarray) and res["t"].tolist() == [0, 1, 2]
    assert isinstance(res["nested"][0], np.ndarray) and res["nested"][1] == 1.5
    assert "boom" in recs[1]["results"]["error"]
    # the failure is recorded as done: the next call skips it, as in JAX
    again = cache.run_exps(exps, run, cache_dir=tmp_path, verbose=False)
    assert "error" in again[1]["results"]
    table = launch.records_table(recs, ("x", "s", "uuid"))
    assert table.splitlines()[0] == f"x=1  s=ok  uuid={recs[0]['uuid']}"
    psnrs = [{"uuid": "a", "results": {"psnrs": [np.array([1.0, 2.0]), 6.0]}},
             {"uuid": "b", "results": {"error": "x"}}]
    assert launch.mean_psnrs(psnrs) == [("a", 3.0)]
    assert cache._to_plain({"d": torch.tensor(2.0)})["d"] == np.float32(2.0)


def test_call_forms(tmp_path):
    seen = []

    def one_arg(cfg):
        seen.append("one")
        return {}

    def with_device(cfg, device=None):
        seen.append(device)
        return {"device": device}

    cache.run_exps([{"x": 1}], one_arg, cache_dir=tmp_path, verbose=False)
    recs = cache.run_exps([{"x": 2}], with_device, cache_dir=tmp_path,
                          device=torch.device("cpu"), verbose=False)
    assert seen == ["one", "cpu"] and recs[0]["results"]["device"] == "cpu"
    assert "device" not in recs[0]["cfg"]


def test_process_backend(tmp_path, no_wandb):
    (tmp_path / "torch_dispatch_target.py").write_text(
        "import os\n"
        "def run(cfg, device=None):\n"
        "    return {'value': cfg['x'] * 2, 'pid': os.getpid(),\n"
        "            'device': device, 'keys': sorted(cfg)}\n")
    sys.path.insert(0, str(tmp_path))
    try:
        from torch_dispatch_target import run as run_fn

        assert dispatch.fn_spec(run_fn) == "torch_dispatch_target::run"
        assert dispatch.worker_cards("cpu") == 0
        exps = cache.load_edata({"a": 1}, [{"x": [1, 2, 3]}])
        recs = cache.run_exps(exps, run_fn, cache_dir=str(tmp_path),
                              proj_name="disp", enable_dispatch="process",
                              use_wandb=True, verbose=False, device="cpu")
        assert sorted(r["results"]["value"] for r in recs) == [2, 4, 6]
        assert os.getpid() not in {r["results"]["pid"] for r in recs}
        assert {r["results"]["device"] for r in recs} == {"cpu"}
        assert all("device" not in r["results"]["keys"] for r in recs)
        assert [r["uuid"] for r in recs] == cache.get_uuids(exps, None)
        assert not list((tmp_path / "disp" / "pending").glob("*.job.pkl"))

        # skip-done across a second dispatch: nothing runs again
        recs2 = cache.run_exps(exps, run_fn, cache_dir=str(tmp_path),
                               proj_name="disp", enable_dispatch="slurm",
                               verbose=False, device="cpu")
        assert [r["results"] for r in recs2] == [r["results"] for r in recs]
        assert len(list((tmp_path / "wandb" / "disp").glob("*.jsonl"))) == 3
    finally:
        sys.path.remove(str(tmp_path))


def test_slurm_falls_back_to_pool(tmp_path, monkeypatch, capsys):
    (tmp_path / "torch_dispatch_target2.py").write_text(
        "import os\n"
        "def run(cfg):\n"
        "    return {'pid': os.getpid()}\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(dispatch.shutil, "which", lambda name: None)
    from torch_dispatch_target2 import run as run_fn

    recs = cache.run_exps([{"x": 1}], run_fn, cache_dir=str(tmp_path),
                          proj_name="s", enable_dispatch="slurm")
    assert "falling back to process pool" in capsys.readouterr().out
    assert recs[0]["results"]["pid"] != os.getpid()
