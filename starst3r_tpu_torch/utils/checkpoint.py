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
           "group_flat", "rebuild", "tree_prefix_overwrite")

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


def _cast(arr: np.ndarray, like):
    """``arr`` with the dtype of ``like`` (a tensor leaf: a tensor on its
    device)."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(device=like.device, dtype=like.dtype)
    return arr.astype(np.asarray(like).dtype)


def _rebuild(like, path: Tuple[str, ...], flat: Dict[str, np.ndarray],
             name: str, cast: bool):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, path + (str(k),), flat, name, cast)
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*[_rebuild(v, path + (f,), flat, name, cast)
                            for f, v in zip(like._fields, like)])
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, path + (str(i),), flat, name, cast)
                          for i, v in enumerate(like))
    key = _SEP.join(path)
    if key not in flat:
        raise KeyError(f"checkpoint {name!r} missing leaf {key!r}")
    return _cast(flat[key], like) if cast else flat[key]


def rebuild(like: Any, flat: Dict[str, np.ndarray], name: str,
            cast: bool = False) -> Any:
    """``like``'s structure with every leaf taken from ``flat`` under its
    path key (cast to the leaf's dtype when ``cast``); a missing key raises
    KeyError naming ``name`` and the leaf."""
    return _rebuild(like, (), flat, name, cast)


def restore_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like``: every leaf of ``like`` is
    replaced by the saved numpy array under its path key (dtype and shape
    as saved); a leaf the file lacks raises KeyError."""
    return rebuild(like, load_flat(path), path)


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint as a flat {path key: array} dict."""
    with np.load(path, allow_pickle=False) as data:
        return {k: data[k] for k in data.files if k != "__treedef__"}


def group_flat(flat: Dict[str, np.ndarray], prefix: str
               ) -> Dict[str, np.ndarray]:
    """Sub-dict of keys under ``prefix + '/'``, with the prefix stripped."""
    p = prefix + _SEP
    return {k[len(p):]: v for k, v in flat.items() if k.startswith(p)}


def tree_prefix_overwrite(new_tree: Any, prev_tree: Any, axis: int = 0
                          ) -> Any:
    """Overwrite the leading entries of every leaf of ``new_tree`` along
    ``axis`` with the matching leaf of ``prev_tree`` (the reference's warm
    start: "if more cameras were added, only the first N params are set to
    prev_params", starster/reconstruct.py:136-147,408-415). Leaves whose
    other dims differ are overwritten over the common slice; a ``None`` in
    ``prev_tree`` keeps ``new_tree``'s leaf. Trees are nested dicts,
    tuples, NamedTuples and lists of tensors or arrays; the result's
    leaves are new tensors of ``new_tree``'s dtype and device. The common
    slice starts every dim at 0, ``axis`` included, so ``axis`` (the JAX
    package's parameter) selects nothing the slice does not."""
    if prev_tree is None or new_tree is None:
        return new_tree
    if isinstance(new_tree, dict):
        return {k: tree_prefix_overwrite(v, prev_tree[k], axis)
                for k, v in new_tree.items()}
    if _is_namedtuple(new_tree):
        return type(new_tree)(*[tree_prefix_overwrite(n, p, axis)
                                for n, p in zip(new_tree, prev_tree)])
    if isinstance(new_tree, (tuple, list)):
        return type(new_tree)(tree_prefix_overwrite(n, p, axis)
                              for n, p in zip(new_tree, prev_tree))
    new = torch.as_tensor(new_tree)
    prev = torch.as_tensor(prev_tree, dtype=new.dtype, device=new.device)
    common = tuple(slice(0, min(a, b)) for a, b in zip(new.shape,
                                                       prev.shape))
    out = new.clone()
    out[common] = prev[common]
    return out
