"""Checkpoints of nested tensors and arrays (port of
`starst3r_tpu/utils/checkpoint.py`), in the JAX package's file format key
for key, so a file written by either package loads in the other.

Format: one ``.npz`` whose entries are the tree's leaves under
``"/"``-joined path keys, as JAX's `tree_flatten_with_path` names them: a
dict entry by its key (dicts walked in sorted key order), a tuple or list
entry by its index, a NamedTuple field by its name; ``None`` and empty
containers hold no leaf. A ``__treedef__`` uint8 entry records the
structure (here the JSON list of the keys, in the JAX package the treedef's
string); it is a record only, and neither package's loader reads it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

__all__ = ("flatten", "save_pytree", "restore_pytree", "load_flat",
           "group_flat")

_SEP = "/"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, path: Tuple[str, ...]) -> Iterator[Tuple[str, Any]]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _walk(v, path + (name,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flatten(tree) -> Dict[str, np.ndarray]:
    """{path key: numpy array} of every leaf of ``tree``."""
    return {k: _leaf(v) for k, v in _walk(tree, ())}


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors / arrays to ``path`` (npz format, the name
    kept as given: written through a file handle, so no ".npz" is appended
    to an extension-less path such as ``scene.ckpt``)."""
    flat = flatten(tree)
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)
    treedef = json.dumps(list(flat)).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __treedef__=np.frombuffer(treedef, dtype=np.uint8),
                 **flat)
    os.replace(tmp, path)


def _rebuild(like, path: Tuple[str, ...], flat: Dict[str, np.ndarray],
             name: str):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, path + (str(k),), flat, name)
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*[_rebuild(v, path + (f,), flat, name)
                            for f, v in zip(like._fields, like)])
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, path + (str(i),), flat, name)
                          for i, v in enumerate(like))
    key = _SEP.join(path)
    if key not in flat:
        raise KeyError(f"checkpoint {name!r} missing leaf {key!r}")
    return flat[key]


def restore_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: every leaf of ``like`` is
    replaced by the saved numpy array under its path key (dtype and shape
    as saved); a leaf the file lacks raises KeyError."""
    return _rebuild(like, (), load_flat(path), path)


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint as a flat {path key: array} dict."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files if k != "__treedef__"}


def group_flat(flat: Dict[str, np.ndarray], prefix: str
               ) -> Dict[str, np.ndarray]:
    """Sub-dict of keys under ``prefix + '/'``, with the prefix stripped."""
    p = prefix + _SEP
    return {k[len(p):]: v for k, v in flat.items() if k.startswith(p)}
