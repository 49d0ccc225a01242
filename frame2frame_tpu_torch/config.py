"""``Config``: a dict with attribute access, what ``flow.api.run_flows``
returns. The port's own copy of the class in ``frame2frame_tpu/config.py``
(the reference used ``easydict.EasyDict``); the rest of that module follows
with the code that needs it."""

from __future__ import annotations

import copy


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
