"""Config system: ``Config`` (a dict with attribute access), the "pairs"
extractors and the grids of configs.

The port's own copy of ``frame2frame_tpu/config.py``, the replacement for
the reference's external ``dev_basics.configs.ExtractConfig`` "pairs"
pattern (reference: lib/frame2frame/lightning.py:77-99,
lib/frame2frame/test.py:36-47, lib/frame2frame/dncnn/io.py:68-80) and
``easydict.EasyDict``.

Each module declares a dict of ``key -> default`` ("pairs"); ``extract_pairs``
pulls the values present in a user config, filling defaults.
``cfg_grid``/``mesh_grids`` expand grids of configs the way the reference's
external ``cache_io.exps.load_edata`` did (reference:
scripts/instances_adapt.py:433,477-509); ``cfg_uuid`` gives the JAX package's
uuid for the same dict.
"""

from __future__ import annotations

import copy
import hashlib
import itertools
import json


class Config(dict):
    """Dict with attribute access (EasyDict equivalent)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def copy(self):
        return Config(copy.deepcopy(dict(self)))


def optional(cfg, key, default):
    """Return ``cfg[key]`` if present and not None, else ``default``.

    Mirrors the reference's ``dev_basics.utils.misc.optional`` call sites
    (e.g. lib/frame2frame/__init__.py:20).
    """
    if cfg is None:
        return default
    if isinstance(cfg, dict):
        val = cfg.get(key, None)
    else:
        val = getattr(cfg, key, None)
    return default if val is None else val


def extract_pairs(cfg, pairs):
    """Extract ``pairs`` keys from ``cfg``, using pair values as defaults."""
    return Config({k: optional(cfg, k, v) for k, v in pairs.items()})


def dcat(*cfgs):
    """Merge configs left-to-right (later wins)."""
    out = Config()
    for c in cfgs:
        if c:
            out.update(c)
    return out


def cfg_grid(base, grid):
    """Expand a dict of ``key -> list`` into a list of configs layered on ``base``.

    Cartesian product over the grid keys, preserving key order.
    """
    base = Config(base or {})
    keys = list(grid.keys())
    vals = [v if isinstance(v, (list, tuple)) else [v] for v in grid.values()]
    exps = []
    for combo in itertools.product(*vals):
        cfg = base.copy()
        for k, v in zip(keys, combo):
            cfg[k] = v
        exps.append(cfg)
    return exps


def mesh_grids(base, grids):
    """Expand several grids (list of dicts of lists) and concatenate."""
    exps = []
    for grid in grids:
        exps.extend(cfg_grid(base, grid))
    return exps


def cfg_uuid(cfg, length=12):
    """Deterministic uuid for a config (replacement for cache_io uuids)."""
    blob = json.dumps({k: cfg[k] for k in sorted(cfg)}, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:length]


class ExtractConfig:
    """Two-phase config extraction mirroring the reference pattern.

    Modules decorate their entry point with ``@econfig.set_init`` and call
    ``econfig.init(cfg)``; when invoked through :meth:`extract_config` only the
    declared pairs are collected (no work is done), matching the introspectable
    ``econfig.init``/``is_init`` two-phase pattern at reference test.py:77-82.
    """

    def __init__(self, fname=""):
        self.fname = fname
        self.is_init = False
        self._pairs = Config()
        self._init_fn = None

    def set_init(self, fn):
        self._init_fn = fn
        return fn

    def init(self, cfg):
        self._cfg = cfg

    def optional(self, cfg, key, default):
        if self.is_init:
            self._pairs[key] = default
        return optional(cfg, key, default)

    def extract_pairs(self, cfg, pairs):
        if self.is_init:
            self._pairs.update(pairs)
        return extract_pairs(cfg, pairs)

    def __call__(self, named_pairs):
        """Extract a dict of named pairs-dicts at once."""
        out = Config()
        for name, pairs in named_pairs.items():
            out[name] = self.extract_pairs(self._cfg, pairs)
        return out

    def extract_dict_of_pairs(self, cfg, named_pairs, restrict=False):
        out = Config()
        for name, pairs in named_pairs.items():
            out[name] = self.extract_pairs(cfg, pairs)
        return out

    def extract_config(self, cfg):
        """Run the init fn in extraction mode and return the collected pairs."""
        self.is_init = True
        self._pairs = Config()
        try:
            if self._init_fn is not None:
                self._init_fn(Config(cfg or {}))
        finally:
            self.is_init = False
        out = self._pairs
        self._pairs = Config()
        return extract_pairs(cfg, out)
