"""Elementwise free functions of the vf namespace.

Port of the cwise part of `asset_asrl_tpu/VectorFunctions/ops.py` that the
CartPole path reaches; the rest of the namespace is ROADMAP queue 1,
item 12.
"""

from __future__ import annotations

import torch

from .function import _stack_arg

__all__ = ["sin", "cos"]


def _cwise(op, name):
    def apply(f):
        return _stack_arg(f).cwise(op, name=name)
    apply.__name__ = name
    return apply


sin = _cwise(torch.sin, "sin")
cos = _cwise(torch.cos, "cos")
