"""Data parallelism of the offline trainer: a training forward split by rows
over a ``(data,)`` mesh, with BatchNorm statistics of the whole batch.

The JAX package shards the batch and replicates the parameters, and XLA's
SPMD partitioner adds the reductions: a step is the single-device step, with
BatchNorm statistics of the whole batch (sync-BN). The port does the same
from one controller:

- each shard runs the model's forward on its own rows, on its own device,
  with the parameters moved there by ``.to`` (autograd carries the
  gradients back to the one copy on the mesh's first device);
- the shards' BatchNorm layers meet once a layer: each shard runs in a
  thread of its own, and the threads take turns in shard order
  (``Lockstep``), shard k running until its next BatchNorm sum and then
  handing over to shard k + 1; the last adds the partial sums in shard
  order on the first device, so a run gives the same bits twice, and hands
  the sum back through differentiable ``.to`` moves (``models/sync_bn.py``);
- the running statistics move once, from the whole batch's statistics;
- the outputs are gathered on the first device, where the loss, the flows
  and the optimizer run over the whole batch.

One turn at a time means one thread at a time: on one card the shards run
one after another, as they would in a loop; on several cards each shard's
launches go to its own card, where they run alongside the others'.
"""

from __future__ import annotations

import copy
import threading

import torch
from torch.func import functional_call

from ..models import sync_bn
from ..ops.fused_spatial import _current, _psum


class _Aborted(Exception):
    """Another shard failed; this one stops at its next turn."""


class Lockstep:
    """Runs one function a shard, each in a thread of its own, one thread at
    a time in shard order; ``sum(k, part)`` hands the turn on and returns
    the sum of every shard's part (``models/sync_bn.py``'s group)."""

    def __init__(self, devices):
        self.devices = list(devices)
        self.n = len(self.devices)
        self._cv = threading.Condition()

    def _pass_turn(self, k):
        for j in range(1, self.n + 1):
            c = (k + j) % self.n
            if not self._done[c]:
                self._turn = c
                break
        self._cv.notify_all()

    def _wait_turn(self, k):
        self._cv.wait_for(lambda: self._turn == k or self._error is not None)
        if self._error is not None:
            raise _Aborted

    def sum(self, k, part):
        """The sum over shards of ``part``, added in shard order on the
        first shard's device, on shard k's device."""
        with self._cv:
            if any(self._done):
                raise RuntimeError("the shards' forwards took different "
                                   "paths: a BatchNorm sum is missing")
            self._parts[k] = part
            if k == self.n - 1:
                self._total = _psum(self._parts)
                self._parts = [None] * self.n
            self._pass_turn(k)
            self._wait_turn(k)
            return self._total.to(part.device)

    def run(self, fns):
        """[fn() for fn in fns], fn k in its thread with device k current
        and grad mode as the caller's; re-raises the first failure."""
        self._turn, self._error = 0, None
        self._done = [False] * self.n
        self._parts = [None] * self.n
        grad = torch.is_grad_enabled()
        outs = [None] * self.n

        def body(k):
            try:
                with self._cv:
                    self._wait_turn(k)
                with torch.set_grad_enabled(grad), \
                        _current(self.devices[k]), sync_bn.shard_of(self, k):
                    outs[k] = fns[k]()
            except BaseException as e:  # handed to the caller below
                with self._cv:
                    if self._error is None and not isinstance(e, _Aborted):
                        self._error = e
                    self._cv.notify_all()
            finally:
                with self._cv:
                    self._done[k] = True
                    self._pass_turn(k)

        threads = [threading.Thread(target=body, args=(k,), daemon=True)
                   for k in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self._error is not None:
            raise self._error
        return outs


class DataParallel:
    """The training forward of ``model`` over the data shards of ``mesh``.

    ``dp(x) -> (out, buffers)``: ``x`` (N, ...) on the mesh's first device,
    where ``model`` lives, split into the shards' rows (N must be at least
    the shard count; shard k takes the k-th of ``x.tensor_split(n)``);
    ``out`` the shards' outputs in order on the first device, differentiable
    with respect to ``model``'s parameters; ``buffers`` the model's buffers
    (in ``model.buffers()`` order) after one training forward of the whole
    batch, which leaves the module's own as they were. Each shard computes
    on a replica of the module (one a shard: a forward patches its module's
    attributes, and shards interleave) that holds no state of its own."""

    def __init__(self, model, mesh):
        self.model = model
        self.mesh = mesh
        self.devices = [row[0] for row in mesh.devices]
        self.replicas = [copy.deepcopy(model).to(d) for d in self.devices]

    @property
    def n(self):
        return len(self.devices)

    def __call__(self, x):
        if x.shape[0] < self.n:
            raise ValueError(f"{x.shape[0]} rows do not split over "
                             f"{self.n} data shards")
        params = dict(self.model.named_parameters())
        buffers = dict(self.model.named_buffers())
        rows = x.tensor_split(self.n)

        def shard(k):
            dev = self.devices[k]
            state = {name: p.to(dev) for name, p in params.items()}
            state.update({name: b.detach().to(dev, copy=True)
                          for name, b in buffers.items()})
            replica = self.replicas[k].train()
            out = functional_call(replica, state, (rows[k].to(dev),))
            return out, [state[name] for name in buffers]

        results = Lockstep(self.devices).run(
            [lambda k=k: shard(k) for k in range(self.n)])
        first = self.devices[0]
        out = torch.cat([o.to(first) for o, _ in results])
        return out, [b.to(first) for b in results[0][1]]
