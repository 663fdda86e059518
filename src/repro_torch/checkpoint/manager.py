"""Checkpointing: atomic, keep-N, async (port of
``repro.checkpoint.manager``).

Layout, as the reference's: ``<dir>/step_<N>.npz`` (flat path -> array)
plus ``step_<N>.json`` (metadata) and a ``step_<N>.done`` marker, written
last. Arrays go to a temporary file first and are renamed into place, so a
crash mid-save never corrupts the latest checkpoint. bf16 leaves are stored
as their uint16 bits (key suffix ``@bf16``). A ``torch.Generator`` leaf is
stored as its state bytes (``@rng``) and restored onto a new generator on
the target's device.

Packed FP8 leaves: a >= 2-D float leaf whose bits unpack back exactly from
its E4M4 codes relative to its pow2 reference (as in-situ FP8 weights do)
is stored as its packed code and sign planes plus that reference and the
format (``@f8code``, ``@f8sign``, ``@f8scale``, ``@f8fmt``): two bytes per
value, the at-rest form the crossbars hold. Any other leaf is stored as it
is, so packing never changes what is restored.

Async mode copies every leaf to the host on the caller's thread (the sync
point) and writes on a background thread; ``wait()`` joins it, and is
called before the next save.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import float8

Tree = Any


PACK_FMT = float8.E4M4  # the TimeFloats storage format


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


# Elements per pass of the packing check: its temporaries are a few times
# this many words, not a few times the leaf (a 0.93e9-element head would
# need ~20 GB beside a full card's training state).
PACK_SLAB = 1 << 26


def _pack_leaf(t: torch.Tensor, fmt: float8.FloatFormat = PACK_FMT
               ) -> Optional[Dict[str, np.ndarray]]:
    """The packed planes of ``t`` if unpacking them restores its bits. The
    fields are elementwise after the per-tensor scale, so the leaf is taken
    in slabs of ``PACK_SLAB`` elements."""
    s = float8.pow2_amax_scale(t, fmt)
    flat = t.reshape(-1)
    code, sign = [], []
    for i in range(0, flat.numel(), PACK_SLAB):
        part = flat[i:i + PACK_SLAB]
        fields = float8.decompose(part.to(torch.float32) * s, fmt)
        back = (float8.compose(fields, fmt) / s).to(t.dtype)
        if not torch.equal(_bits(back), _bits(part)):
            return None
        p = float8.pack(fields, fmt)
        code.append(p.code.cpu())
        sign.append(p.signbit.cpu())
    return {"@f8code": torch.cat(code).reshape(t.shape).numpy(),
            "@f8sign": torch.cat(sign).reshape(t.shape).numpy(),
            "@f8scale": s.cpu().numpy(),
            "@f8fmt": np.array([fmt.exp_bits, fmt.man_bits])}


def _unpack_leaf(data, key: str, like: torch.Tensor) -> torch.Tensor:
    fmt = float8.FloatFormat(*(int(v) for v in data[key + "@f8fmt"]))
    p = float8.PackedF8(torch.from_numpy(data[key + "@f8code"]),
                        torch.from_numpy(data[key + "@f8sign"]))
    v = float8.compose(float8.unpack(p, fmt), fmt)
    return (v / torch.from_numpy(data[key + "@f8scale"])).to(like.dtype)


def _flatten(tree: Tree) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for path, leaf in tree_lib.leaves_with_path(tree):
        key = tree_lib.path_str(path)
        if isinstance(leaf, torch.Generator):
            flat[key + "@rng"] = leaf.get_state().numpy()
            continue
        if not isinstance(leaf, torch.Tensor):
            flat[key] = np.asarray(leaf)
            continue
        t = leaf.detach()
        if t.ndim >= 2 and t.dtype in (torch.float32, torch.bfloat16):
            packed = _pack_leaf(t)
            if packed is not None:
                flat.update({key + k: v for k, v in packed.items()})
                continue
        if t.dtype == torch.bfloat16:
            flat[key + "@bf16"] = t.view(torch.int16).cpu().numpy().view(
                np.uint16)
        else:
            flat[key] = t.cpu().numpy()
    return flat


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Tree, metadata: Optional[dict] = None):
        self.wait()
        flat = _flatten(tree)  # device -> host, on the caller's thread
        meta = dict(metadata or {}, step=step, time=time.time())
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_catching, args=(step, flat, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, meta)

    def _write_catching(self, step, flat, meta):
        try:
            self._write(step, flat, meta)
        except Exception as e:  # re-raised by wait() on the caller
            self._error = e

    def _write(self, step: int, flat: Dict[str, np.ndarray], meta: dict):
        tmp = os.path.join(self.dir, f".tmp_step_{step}.npz")
        final = os.path.join(self.dir, f"step_{step}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)  # atomic
        with open(os.path.join(self.dir, f"step_{step}.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(self.dir, f"step_{step}.done"), "w") as f:
            f.write("ok")
        self._gc()

    def wait(self):
        """Join the pending write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: max(0, len(steps) - self.keep)]:
            for suffix in (".npz", ".json", ".done"):
                try:
                    os.remove(os.path.join(self.dir, f"step_{s}{suffix}"))
                except FileNotFoundError:
                    pass

    # -- load ---------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)\.done", name)
            if m and os.path.exists(os.path.join(self.dir,
                                                 f"step_{m.group(1)}.npz")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Tree) -> Tree:
        """Load ``step`` into the structure of ``target``: each tensor leaf
        comes back with the target leaf's shape, dtype and device."""
        with np.load(os.path.join(self.dir, f"step_{step}.npz")) as data:
            def load(path, leaf):
                key = tree_lib.path_str(path)
                if isinstance(leaf, torch.Generator):
                    gen = torch.Generator(device=leaf.device)
                    gen.set_state(torch.from_numpy(data[key + "@rng"]))
                    return gen
                if not isinstance(leaf, torch.Tensor):
                    return type(leaf)(data[key])
                if key + "@f8code" in data:
                    t = _unpack_leaf(data, key, leaf)
                elif key + "@bf16" in data:
                    t = torch.from_numpy(data[key + "@bf16"].view(np.int16)
                                         ).view(torch.bfloat16)
                elif key in data:
                    t = torch.from_numpy(data[key])
                else:
                    raise KeyError(f"checkpoint missing {key}")
                if tuple(t.shape) != tuple(leaf.shape):
                    raise ValueError(f"{key}: ckpt {tuple(t.shape)} != "
                                     f"{tuple(leaf.shape)}")
                return t.to(device=leaf.device, dtype=leaf.dtype)

            return tree_lib.tree_map_with_path(load, target)
