"""Building the port's module trees over tensors the benchmark made."""
from __future__ import annotations

from torch import nn


def module(cls, **leaves):
    """An instance of the port's ``nn.Module`` class ``cls`` whose
    attributes are ``leaves``: tensors become frozen parameters over the
    same storage, lists of modules a ``ModuleList``. The class's own
    ``__init__``, which draws random weights, is not run."""
    m = cls.__new__(cls)
    nn.Module.__init__(m)
    for name, v in leaves.items():
        if isinstance(v, list):
            v = nn.ModuleList(v)
        elif not isinstance(v, nn.Module):
            v = nn.Parameter(v, requires_grad=False)
        setattr(m, name, v)
    return m
