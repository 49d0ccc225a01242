"""The sharded f2f step and the data-parallel trainer step with one shard a
card, against the same shards all on the first card and the unsharded step.

    python3 scripts/torch_shard_mesh.py [--meshes 4x1,2x2,1x4]
        [--out chiprun_out/shard_mesh.json]

The pretrained DnCNN-17 (``results/dncnn17_s25``) on "fused" (the module
route: the bf16 graph, kernel B for every dW), Adam at 1e-4:

- the f2f step (``parallel/shard.make_sharded_f2f_step``,
  ``train_bn=False``) at 540p, B = T = 4 (``chip_smoke.moving_frames`` at
  four seeds, analytic flows) on each mesh with shard k on card k mod the
  card count, against the same mesh with every shard on cuda:0 (the same
  sums in the same order: the same bits expected, and printed) and against
  the unsharded step (mesh 1x1) where it fits on one card; the loss within
  1e-4, the weights by the adaptation rule (``chip_smoke.hold_update``);
- the data-parallel trainer step (``parallel/data.DataParallel`` in
  ``TrainModule.training_step``, ``crit_name="sup"``, no flows) at B = 4
  540p frames, T = 2, one shard a card, against one card;
- for each: host ms a step (the median of 3 after the first call, each
  ending when every card is done) and the most memory each card held
  during the first call above what it held before; a step that does not
  fit is recorded so.

Prints the card line and one JSON line a case, writes them all to
``--out``, and exits 1 if a hold failed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
TIMED_CALLS = 3
B, T = 4, 4
LR = 1e-4


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--meshes", default="4x1,2x2,1x4",
                    help="(data)x(time) meshes, one shard a card")
    ap.add_argument("--out", default=str(REPO / "chiprun_out"
                                         / "shard_mesh.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_shard_mesh: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from frame2frame_tpu_torch.config import Config
    from frame2frame_tpu_torch.models.dncnn import (
        JaxRavel, from_jax_variables)
    from frame2frame_tpu_torch.models.serialization import load_variables
    from frame2frame_tpu_torch.ops import _build
    from frame2frame_tpu_torch.parallel import mesh as pm
    from frame2frame_tpu_torch.parallel import shard as ps
    from frame2frame_tpu_torch.parallel.data import DataParallel
    from frame2frame_tpu_torch.train.lit import TrainModule
    from frame2frame_tpu_torch.train.online import torch_adam
    from frame2frame_tpu_torch.train.schedules import make_optimizer
    from frame2frame_tpu_torch.train.state import TrainState

    card = cs.card_line()
    print(card, flush=True)
    _build.build_all()
    n_cards = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    dev = cards[0]
    meshes = [tuple(int(v) for v in m.split("x"))
              for m in args.meshes.split(",")]
    variables = load_variables(cs.CKPT)
    rows = [cs.moving_frames(T, seed=s) for s in (3, 7, 11, 13)][:B]
    noisy = torch.from_numpy(np.stack([r[1] for r in rows])).to(dev)
    clean = np.stack([r[0] for r in rows])
    bflow = torch.from_numpy(np.stack([r[2] for r in rows])).to(dev)
    results, failed = [], []

    def sync_all():
        for d in cards:
            torch.cuda.synchronize(d)

    def timed(fn):
        """(first result, host ms a call, GB held above the start a card)."""
        sync_all()
        base = []
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
            base.append(torch.cuda.memory_allocated(d))
        try:
            res = fn()
            sync_all()
        except torch.cuda.OutOfMemoryError:
            torch.cuda.empty_cache()
            return None, None, None
        peak = [(torch.cuda.max_memory_allocated(d) - b) / 2**30
                for d, b in zip(cards, base)]
        ts = []
        for _ in range(TIMED_CALLS):
            t0 = time.perf_counter()
            fn()
            sync_all()
            ts.append((time.perf_counter() - t0) * 1e3)
        return res, float(np.median(ts)), peak

    def emit(rec):
        print(json.dumps(rec), flush=True)
        results.append(rec)

    # the f2f step
    model = from_jax_variables(variables, residual=True,
                               conv_impl="fused").to(dev)
    tx = torch_adam(LR)
    opt0 = tx.init(JaxRavel(model).ravel())

    def f2f(shape, devices):
        step = ps.make_sharded_f2f_step(
            model, pm.make_mesh(*shape, devices=devices), tx,
            train_bn=False)
        return lambda: step(variables["params"], variables["batch_stats"],
                            opt0, noisy, bflow)

    ref, ref_ms, ref_peak = timed(f2f((1, 1), [dev]))
    emit({"case": "f2f 1x1 (unsharded, one card)", "ms": ref_ms,
          "peak_gib": ref_peak, "fits": ref is not None,
          "loss": None if ref is None else float(ref[3])})
    for shape in meshes:
        n = shape[0] * shape[1]
        spread = [cards[k % n_cards] for k in range(n)]
        one, one_ms, one_peak = timed(f2f(shape, [dev] * n))
        got, ms, peak = timed(f2f(shape, spread))
        rec = {"case": f"f2f {shape[0]}x{shape[1]}", "ms_cards": ms,
               "peak_gib_cards": peak, "ms_one_card": one_ms,
               "peak_gib_one_card": one_peak}
        if got is None or one is None:
            rec["fits"] = False
            failed.append(rec["case"])
        else:
            rec["loss"] = float(got[3])
            rec["same_bits_as_one_card"] = bool(
                float(got[3]) == float(one[3])
                and np.array_equal(cs.tree_flat(got[0]),
                                   cs.tree_flat(one[0])))
            if ref is not None:
                rel = abs(float(got[3]) - float(ref[3])) / abs(float(ref[3]))
                rec["loss_rel_vs_unsharded"] = rel
                try:
                    share, worst = cs.hold_update(
                        rec["case"], got[0], ref[0], LR)
                    rec.update(weights_share=share, weights_max_err=worst)
                    if rel > cs.SHARD_LOSS_RTOL:
                        failed.append(rec["case"])
                except cs.SmokeFailure as e:
                    rec["hold"] = str(e)
                    failed.append(rec["case"])
        emit(rec)

    # the data-parallel trainer step, sup, no flows
    cfg = Config(net_name="dncnn", channels=1, num_of_layers=17,
                 crit_name="sup", flow=False, lr_init=1e-4, nepochs=1,
                 batch_size=B)
    batch = {"noisy": np.clip(255.0 * np.stack([r[1] for r in rows])[:, :2],
                              0, 255).astype(np.float32),
             "clean": (255.0 * clean[:, :2]).astype(np.float32)}

    def trainer_step(devices):
        m = from_jax_variables(variables, residual=True,
                               conv_impl="fused").to(dev)
        module = TrainModule(cfg, m, residual=True)
        txo, _ = make_optimizer(module.cfg, steps_per_epoch=1)
        state = TrainState.create(m, None, txo, residual=True)
        if len(devices) > 1:
            state = state.replace(data_parallel=DataParallel(
                m, pm.make_mesh(len(devices), 1, devices=devices)))
        gen = torch.Generator(dev).manual_seed(0)
        return lambda: module.training_step(state, batch, 0, gen)[1]

    one_out, one_ms, one_peak = timed(trainer_step([dev]))
    spread = [cards[k % n_cards] for k in range(B)]
    dp_out, dp_ms, dp_peak = timed(trainer_step(spread))
    rec = {"case": f"trainer step B={B} one shard a card", "ms_cards": dp_ms,
           "peak_gib_cards": dp_peak, "ms_one_card": one_ms,
           "peak_gib_one_card": one_peak}
    if one_out is None or dp_out is None:
        rec["fits"] = False
        failed.append(rec["case"])
    else:
        rel = (abs(dp_out["train_loss"] - one_out["train_loss"])
               / abs(one_out["train_loss"]))
        rec.update(loss=dp_out["train_loss"], loss_rel_vs_one_card=rel)
        if rel > cs.SHARD_TRAINER_LOSS_RTOL:
            failed.append(rec["case"])
    emit(rec)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps({"card": card, "cards": n_cards,
                                          "results": results}, indent=1))
    print(card)
    if failed:
        print(f"torch_shard_mesh: FAIL: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
