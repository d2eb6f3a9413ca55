"""Checkpoints in the reference's format (the port of
``repro/train/checkpoint.py``).

Format: one ``.npz`` per save (``ckpt_{step:08d}.npz``) whose keys are
``name::a/b/c`` over the reference's key paths, plus a msgpack manifest
(``ckpt_{step:08d}.manifest``) with the step, the time, the sorted keys and
the caller's meta. A state (a model, ``DecoderLM``/``EncDecLM``, or an
``OptState`` per name) is written in the reference's layout: the model
and the optimizer's ``mu``/``nu`` as the reference's nested dicts with every stacked leaf stacked again
(``models.convert.to_reference_tree``), an ``OptState`` under ``.step``,
``.mu`` and ``.nu`` (JAX's path keys of a NamedTuple's fields). So a
checkpoint of either package restores in the other.

The manifest is packed here (``packb``), byte for byte ``msgpack.packb``'s
for the few types a manifest holds (dict, str, int, float, list, tuple,
bool, None), without importing ``msgpack``. Saves run on a background
thread unless ``blocking``; the arrays are fetched to the host first, so
training may go on at once.
"""
from __future__ import annotations

import os
import struct
import threading
import time
from typing import Any

import numpy as np
import torch

from ..models.convert import host_array, reference_leaf, to_reference_tree
from .optimizer import OptState


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` (its defaults: str as str, float as float64)
    for dict, str, int, float, list, tuple, bool and None."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(o, out: bytearray) -> None:
    if o is None:
        out += b"\xc0"
    elif o is True:
        out += b"\xc3"
    elif o is False:
        out += b"\xc2"
    elif isinstance(o, int):
        _pack_int(o, out)
    elif isinstance(o, float):
        out += b"\xcb" + struct.pack(">d", o)
    elif isinstance(o, str):
        b = o.encode("utf-8")
        n = len(b)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 2**8:
            out += b"\xd9" + struct.pack(">B", n)
        elif n < 2**16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += b
    elif isinstance(o, (list, tuple)):
        _header(len(o), 0x90, b"\xdc", b"\xdd", out)
        for x in o:
            _pack(x, out)
    elif isinstance(o, dict):
        _header(len(o), 0x80, b"\xde", b"\xdf", out)
        for k, v in o.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(o).__name__}")


def _header(n: int, fix: int, b16: bytes, b32: bytes, out: bytearray) -> None:
    if n < 16:
        out.append(fix | n)
    elif n < 2**16:
        out += b16 + struct.pack(">H", n)
    else:
        out += b32 + struct.pack(">I", n)


def _pack_int(i: int, out: bytearray) -> None:
    if 0 <= i < 128:
        out.append(i)
    elif -32 <= i < 0:
        out += struct.pack(">b", i)
    elif i >= 0:
        for code, fmt, top in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16),
                               (0xCE, ">I", 2**32), (0xCF, ">Q", 2**64)):
            if i < top:
                out += bytes([code]) + struct.pack(fmt, i)
                return
        raise OverflowError(i)
    else:
        for code, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                               (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if i >= low:
                out += bytes([code]) + struct.pack(fmt, i)
                return
        raise OverflowError(i)


def _host(x) -> np.ndarray:
    # a copy: the step after a save updates the tensors in place (a DTensor
    # is gathered whole first)
    return host_array(x)


def _as_tree(tree):
    """A state as the reference's tree: nested dicts with sorted keys
    (JAX's order), NamedTuple fields under ``.field``."""
    if isinstance(tree, torch.nn.Module):
        return to_reference_tree(dict(tree.named_parameters()))
    if isinstance(tree, OptState):
        return {".step": tree.step, ".mu": to_reference_tree(tree.mu),
                ".nu": to_reference_tree(tree.nu)}
    return tree


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    tree = _as_tree(tree)
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
        return flat
    return {prefix: _host(tree)}


def _restore_into(template, flat: dict[str, np.ndarray]):
    """Copy the arrays of ``flat`` into ``template``'s tensors (a model or
    an ``OptState``) and return it."""
    def fill(named: dict, prefix: str):
        tree = _unflatten(flat, prefix)
        with torch.no_grad():
            for name, t in named.items():
                try:
                    a = reference_leaf(tree, name)
                except KeyError:
                    raise KeyError(f"checkpoint missing {prefix}/{name}") from None
                if tuple(a.shape) != tuple(t.shape):
                    raise ValueError(f"shape mismatch for {name}: ckpt {a.shape} vs model "
                                     f"{tuple(t.shape)}")
                src = torch.as_tensor(a).to(t.dtype)
                if hasattr(t, "device_mesh"):   # a DTensor keeps its placements
                    from torch.distributed.tensor import distribute_tensor
                    src = distribute_tensor(src.to(t.device_mesh.device_type), t.device_mesh,
                                            t.placements, src_data_rank=None)
                t.copy_(src)

    if isinstance(template, torch.nn.Module):
        fill(dict(template.named_parameters()), "")
        return template
    if isinstance(template, OptState):
        fill(template.mu, ".mu")
        fill(template.nu, ".nu")
        if ".step" not in flat:
            raise KeyError("checkpoint missing .step")
        return OptState(torch.as_tensor(flat[".step"].astype(np.int32)).to(template.step.device),
                        template.mu, template.nu)
    raise TypeError(f"cannot restore into a {type(template).__name__}: a model or an OptState")


def _replace(state, shardings: dict):
    """``state`` (a model or an ``OptState``) with the tensors ``shardings``
    names distributed as it says."""
    from torch.distributed.tensor import distribute_tensor

    def place(t, sh):
        return distribute_tensor(t.detach(), sh.mesh, list(sh.placements), src_data_rank=None)
    if isinstance(state, torch.nn.Module):
        from ..models.transformer import set_param
        for name, w in list(state.named_parameters()):
            if name in shardings:
                set_param(state, name, torch.nn.Parameter(place(w, shardings[name]),
                                                          requires_grad=w.requires_grad))
        return state
    if isinstance(state, OptState):
        mu, nu = ({k: place(t, shardings[k]) if k in shardings else t for k, t in d.items()}
                  for d in (state.mu, state.nu))
        return OptState(state.step, mu, nu)
    raise TypeError(f"cannot re-place a {type(state).__name__}")


def _unflatten(flat: dict[str, np.ndarray], prefix: str) -> dict:
    """The nested dicts under ``prefix`` of the flat ``a/b/c`` keys."""
    tree: dict = {}
    head = f"{prefix}/" if prefix else ""
    for key, a in flat.items():
        if not key.startswith(head):
            continue
        node = tree
        parts = key[len(head):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = a
    return tree


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    def _paths(self, step: int) -> tuple[str, str]:
        return (os.path.join(self.dir, f"ckpt_{step:08d}.npz"),
                os.path.join(self.dir, f"ckpt_{step:08d}.manifest"))

    def save(self, step: int, state: dict[str, Any], meta: dict | None = None,
             blocking: bool = False):
        flat = {}
        for name, tree in state.items():
            for k, v in _flatten(tree).items():
                flat[f"{name}::{k}"] = v

        def _write():
            npz_path, man_path = self._paths(step)
            tmp = npz_path + ".tmp.npz"
            np.savez(tmp, **flat)
            os.replace(tmp, npz_path)
            with open(man_path, "wb") as f:
                f.write(packb({"step": step, "time": time.time(),
                               "keys": sorted(flat.keys()), **(meta or {})}))
            self._gc()

        if blocking:
            _write()
        else:
            self.wait()
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            for p in self._paths(s):
                try:
                    os.remove(p)
                except OSError:
                    pass

    def all_steps(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".manifest"):
                out.append(int(f[5:13]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, templates: dict[str, Any],
                shardings: dict[str, Any] | None = None) -> dict[str, Any]:
        """The saved state of ``step``, written into ``templates``' tensors
        (on their devices, in their dtypes): a model or an ``OptState`` per
        name. ``shardings`` optionally re-places a name's tensors on a mesh
        (elastic restart under a new mesh): ``{name: {parameter name:
        Sharding}}`` (``launch.shardings.param_shardings``), applied to a
        model's parameters or an ``OptState``'s moments; each rank keeps
        its shards of the restored values."""
        npz_path, _ = self._paths(step)
        with np.load(npz_path) as data:
            out = {}
            for name, template in templates.items():
                flat = {k.split("::", 1)[1]: data[k] for k in data.files
                        if k.startswith(f"{name}::")}
                out[name] = _restore_into(template, flat)
                if shardings and shardings.get(name) is not None:
                    out[name] = _replace(out[name], shardings[name])
        return out
