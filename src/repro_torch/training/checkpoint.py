"""Msgpack checkpoints of the PyTorch port, in the layout of the JAX
package's ``training/checkpoint.py``: one .msgpack file holding one map
{flat key: {dtype, shape, data}}, the keys the tree's paths ("/k" for a
dict key, "/[i]" for a list or tuple item, dict keys sorted), so a file
written by either package loads into the other. bf16 is stored under
the dtype name "bfloat16" as the JAX package's arrays store it (its raw
16-bit words).

Trees hold tensors or numpy arrays. A model's parameters take the JAX
tree's layout first (``repro_torch.bridge.params_to_numpy``), so their
checkpoint has the JAX keys. ``msgpack`` is imported by the two functions
only: importing ``repro_torch.training`` does not need it.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/[{i}]"))
    else:
        out[prefix] = tree
    return out


def _entry(v):
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        v = t.numpy()
    arr = np.asarray(v)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tobytes()}


def save_checkpoint(path: str, tree: Any) -> None:
    import msgpack
    payload = {k: _entry(v) for k, v in _flatten(tree).items()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(payload))
    os.replace(tmp, path)


def _tensor(ent, like):
    shape = tuple(ent["shape"])
    if ent["dtype"] == "bfloat16":
        t = torch.frombuffer(bytearray(ent["data"]), dtype=torch.int16)
        t = t.view(torch.bfloat16).reshape(shape)
    else:
        arr = np.frombuffer(ent["data"], dtype=ent["dtype"]).reshape(shape)
        t = torch.from_numpy(arr.copy())
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(dev)


def _restore(tree, payload, prefix=""):
    if isinstance(tree, dict):
        return {k: _restore(v, payload, f"{prefix}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore(v, payload, f"{prefix}/[{i}]")
                          for i, v in enumerate(tree))
    t = _tensor(payload[prefix], tree)
    if tuple(t.shape) != tuple(tree.shape):
        raise ValueError(f"{prefix}: stored {tuple(t.shape)}, expected "
                         f"{tuple(tree.shape)}")
    return t


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes must match):
    tensors in the stored type, each on its ``like`` leaf's device (the
    CPU for a numpy leaf)."""
    import msgpack
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read())
    return _restore(like, payload)
