"""Fault-tolerant checkpoints in the reference's format.

Counterpart of ``repro.train.checkpoint``: one ``arrays.npz`` (a zip of
npy records) and a ``manifest.json`` per step directory, holding the
``step``, a CRC32 per record (``crc``), the records' ``shapes`` and
``dtypes``, the ``quant`` tags (``[block, codec]`` per int8 moment) and
the caller's ``extra``.  Records are named by the reference's
``||``-joined paths (``params||groups||0``, ``opt||groups||2||m||q``,
``opt||step``, ``opt||key``), with the reference's shapes and dtypes, so
a training checkpoint written by either package restores in the other.

* step-atomic and durable: the npz is written and fsynced, then the
  manifest, the tmp dir is fsynced, renamed into place (a published
  step being replaced is first moved aside as ``.replaced.tmp``), the
  workdir fsynced, and only then are old steps collected (keep-k);
* integrity: every record's CRC is checked on restore; a damaged step is
  quarantined as ``step_*.corrupt`` (never deleted) and
  :func:`restore_latest` walks back to the newest intact one;
* template-based restore: the caller's tree gives the structure, the
  dtypes and the device of every tensor, and an fp32 moment record
  fills an int8 template and the other way round
  (:func:`_migrate_state_dtype`); tensors land on the template's device.

The port's own state differs from the reference's in two places, both
handled here:

* a ``bfloat16`` tensor is written as ``|V2`` void records (the bytes
  numpy gives an ``ml_dtypes`` bfloat16 array) with the manifest's dtype
  ``"bfloat16"``, and read back by that tag;
* the reference's PRNG key becomes a ``torch.Generator``: a
  :class:`~repro_torch.optim.subspace.SubspaceState` writes
  ``opt||key`` (``(2,)`` uint32, derived from the generator's state
  without drawing from it) and the generator's own state as
  ``opt||gen`` (uint8), which the reference ignores.  A restore takes
  ``opt||gen`` when it fits the template's generator, and otherwise (a
  JAX checkpoint, or one written on another device type) seeds the
  generator from ``opt||key``.  A GaLore state's host step counter is
  restored from ``step``.

The reference's migrations of layouts older than its grouped state
(``_migrate_legacy_subspace``, ``_migrate_legacy_grouped_params``) and
its elastic ``shardings`` restore are not ported.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..convert import to_numpy, to_tensor
from ..optim import quant
from ..optim.subspace import GroupedParams, SubspaceState
from . import chaos

SEP = "||"
BF16 = "bfloat16"


class MethodMismatchError(ValueError):
    """Cross-method resume refusal — a configuration error, never
    corruption: :func:`restore_latest` propagates it instead of
    quarantining."""


# What a torn or corrupt checkpoint surfaces as (the reference's list):
# truncated zips raise BadZipFile/EOFError/OSError, torn npy members
# ValueError, a torn manifest JSONDecodeError, CRC or shape drift IOError
# (== OSError), a missing record KeyError.
CORRUPTION_ERRORS = (OSError, EOFError, KeyError, ValueError,
                     zlib.error, zipfile.BadZipFile, json.JSONDecodeError)


# ---------------------------------------------------------------------------
# Records <-> tensors
# ---------------------------------------------------------------------------

def from_record(arr: np.ndarray, name: Optional[str]) -> torch.Tensor:
    """A record as a CPU tensor; void records are read by the manifest's
    dtype tag (``bfloat16``, the only opaque dtype either package
    writes)."""
    if arr.dtype.kind == "V":
        if name != BF16 or arr.dtype.itemsize != 2:
            raise IOError(f"record of opaque dtype {arr.dtype} tagged "
                          f"{name!r}; only bfloat16 is known")
    return to_tensor(arr, "cpu")


def gen_key(gen: torch.Generator) -> np.ndarray:
    """The ``(2,)`` uint32 ``opt||key`` of a generator: a digest of its
    state, read without drawing."""
    digest = hashlib.blake2b(gen.get_state().numpy().tobytes(),
                             digest_size=8).digest()
    return np.frombuffer(digest, np.uint32).copy()


def gen_from(like: torch.Generator, state: Optional[torch.Tensor],
             key: Optional[torch.Tensor]) -> torch.Generator:
    """A new generator on ``like``'s device, set to ``state`` when it
    fits this device's generator, else seeded from ``key``."""
    gen = torch.Generator(device=like.device)
    if state is not None and state.numel() == like.get_state().numel():
        gen.set_state(state.to(torch.uint8))
        return gen
    if key is None:
        raise KeyError("checkpoint holds neither opt||gen nor opt||key")
    k = key.to(torch.int64).tolist()
    gen.manual_seed((k[0] & 0xFFFFFFFF) << 32 | (k[1] & 0xFFFFFFFF))
    return gen


# ---------------------------------------------------------------------------
# The port's containers, in the reference's flatten order
# ---------------------------------------------------------------------------

def _children(node):
    """``[(name, child)]`` of a container in the reference's flatten
    order, or None for a leaf.  A ``SubspaceState``'s generator is not
    a child: :func:`_flatten` writes it as ``key`` and ``gen``."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, quant.QuantizedTensor):
        return [("q", node.q), ("scale", node.scale)]
    if isinstance(node, SubspaceState):
        return [(f, getattr(node, f))
                for f in ("dense", "groups", "step", "outer_step")]
    if isinstance(node, GroupedParams):
        return [("dense", node.dense), ("groups", node.groups)]
    if hasattr(node, "_fields"):          # NamedTuple
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _join(prefix: str, name: str) -> str:
    return prefix + SEP + name if prefix else name


def _flatten(tree) -> tuple:
    """``({key: record}, {key: dtype name}, {key: [block, codec]})``."""
    flat, names, qtags = {}, {}, {}

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, quant.QuantizedTensor):
            qtags[prefix] = [int(node.block), node.codec]
        kids = _children(node)
        if kids is None:
            rec = flat[prefix] = to_numpy(node)
            names[prefix] = BF16 if rec.dtype.kind == "V" else \
                rec.dtype.name
            return
        for name, child in kids:
            walk(child, _join(prefix, name))
        if isinstance(node, SubspaceState):
            for name, rec in (("key", gen_key(node.gen)),
                              ("gen", node.gen.get_state().numpy())):
                flat[_join(prefix, name)] = rec
                names[_join(prefix, name)] = rec.dtype.name

    walk(tree, "")
    return flat, names, qtags


def records(tree) -> dict:
    """``{key: record}``: what :func:`save` would write for ``tree``."""
    return _flatten(tree)[0]


# ---------------------------------------------------------------------------
# Durable save, GC, listing
# ---------------------------------------------------------------------------

def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """fsync a directory: the create and rename entries are directory
    data (some filesystems refuse it; best effort there)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(workdir: str, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Durable step-atomic save (see the module docstring for the order);
    returns the published directory.  ``chaos.maybe_*`` are the
    fault-injection points (no-ops without a hook)."""
    os.makedirs(workdir, exist_ok=True)
    final = os.path.join(workdir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    chaos.maybe_raise("save:pre_arrays")
    flat, names, qtags = _flatten(tree)
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **flat)
    chaos.maybe_truncate(npz_path)
    _fsync_file(npz_path)
    chaos.maybe_raise("save:post_arrays")
    manifest = {
        "step": int(step),
        "crc": {k: zlib.crc32(v.tobytes()) for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": names,
        "quant": qtags,
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_dir(tmp)
    chaos.maybe_raise("save:pre_rename")
    if os.path.exists(final):
        # never remove a published step before its replacement is live
        aside = final + ".replaced.tmp"
        if os.path.exists(aside):
            shutil.rmtree(aside)
        os.rename(final, aside)
        os.rename(tmp, final)
        shutil.rmtree(aside, ignore_errors=True)
    else:
        os.rename(tmp, final)
    _fsync_dir(workdir)
    chaos.maybe_raise("save:post_rename")
    _gc(workdir, keep)
    return final


def _gc(workdir: str, keep: int):
    """Keep the newest ``keep`` published steps (``keep=0``: all); runs
    only after a publish, over published steps only."""
    steps = all_steps(workdir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(workdir, f"step_{s:08d}"),
                      ignore_errors=True)


def clean_stale_tmp(workdir: str) -> list:
    """Delete ``step_*.tmp`` / ``step_*.replaced.tmp`` left by crashed
    saves; quarantined ``.corrupt`` directories stay (evidence)."""
    removed = []
    if not os.path.isdir(workdir):
        return removed
    for name in os.listdir(workdir):
        if re.fullmatch(r"step_\d+(\.replaced)?\.tmp", name):
            shutil.rmtree(os.path.join(workdir, name), ignore_errors=True)
            removed.append(name)
    return removed


def all_steps(workdir: str):
    """Published step numbers, sorted (``.tmp`` and ``.corrupt``
    directories never match)."""
    if not os.path.isdir(workdir):
        return []
    out = []
    for name in os.listdir(workdir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(workdir, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(workdir: str) -> Optional[int]:
    steps = all_steps(workdir)
    return steps[-1] if steps else None


def read_manifest(workdir: str, step: int) -> dict:
    """A published step's manifest, without touching its arrays."""
    path = os.path.join(workdir, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return json.load(f)


def quarantine(workdir: str, step: int) -> str:
    """Move a damaged step aside as ``step_XXXX.corrupt`` (replacing an
    earlier quarantine of the same step)."""
    src = os.path.join(workdir, f"step_{step:08d}")
    dst = src + ".corrupt"
    if os.path.exists(dst):
        shutil.rmtree(dst)
    os.rename(src, dst)
    return dst


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------

class _Archive:
    """One step's npz and manifest; every record read is CRC-checked."""

    def __init__(self, workdir: str, step: int):
        path = os.path.join(workdir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        self.npz = np.load(os.path.join(path, "arrays.npz"))
        self.keys = set(self.npz.files)

    def __contains__(self, key) -> bool:
        return key in self.keys

    def tensor(self, key: str) -> torch.Tensor:
        arr = self.npz[key]
        crc = zlib.crc32(arr.tobytes())
        want = self.manifest["crc"].get(key)
        if crc != want:
            raise IOError(f"checkpoint corruption at leaf {key!r} "
                          f"(crc {crc} != {want})")
        return from_record(arr, (self.manifest.get("dtypes") or {}).get(key))


def _migrate_state_dtype(arc: _Archive, key: str, like):
    """fp32 <-> int8 optimizer-state migration, both ways: an fp32 moment
    record fills an int8 template node (quantized with the template's
    block and codec), a saved ``(q, scale)`` pair fills an fp32 template
    tensor (decoded with the manifest's ``quant`` tag).  Returns None
    when the archive holds neither form."""
    if quant.is_quantized(like):
        if key not in arc:
            return None
        x = arc.tensor(key).to(like.q.device, torch.float32)
        return quant.quantize(x, block=like.block, codec=like.codec)
    if key + SEP + "q" not in arc:
        return None
    block, codec = (arc.manifest.get("quant") or {}).get(
        key, [quant.QBLOCK, "linear"])
    dev = like.device
    qt = quant.QuantizedTensor(q=arc.tensor(key + SEP + "q").to(dev),
                               scale=arc.tensor(key + SEP + "scale").to(dev),
                               block=int(block), codec=str(codec))
    return quant.dequantize(qt).to(like.dtype)


def _rebuild(node, prefix: str, arc: _Archive):
    """``node`` (the template) with every leaf read from ``arc``."""
    if node is None:
        return None
    if quant.is_quantized(node):
        if prefix + SEP + "q" not in arc:
            got = _migrate_state_dtype(arc, prefix, node)
            if got is None:
                raise IOError(f"checkpoint missing leaf {prefix!r}")
            return got
        return dataclasses.replace(
            node, q=_rebuild(node.q, _join(prefix, "q"), arc),
            scale=_rebuild(node.scale, _join(prefix, "scale"), arc))
    kids = _children(node)
    if kids is None:
        if not torch.is_tensor(node):
            raise TypeError(f"template leaf {prefix!r} is a "
                            f"{type(node).__name__}, not a tensor")
        if prefix not in arc:
            got = _migrate_state_dtype(arc, prefix, node)
            if got is None:
                raise IOError(f"checkpoint missing leaf {prefix!r}")
            return got
        t = arc.tensor(prefix)
        if tuple(t.shape) != tuple(node.shape):
            raise IOError(f"checkpoint leaf {prefix!r} has shape "
                          f"{tuple(t.shape)}, the template "
                          f"{tuple(node.shape)}")
        return t.to(device=node.device, dtype=node.dtype)
    new = {name: _rebuild(child, _join(prefix, name), arc)
           for name, child in kids}
    if isinstance(node, SubspaceState):
        gk, kk = _join(prefix, "gen"), _join(prefix, "key")
        new["gen"] = gen_from(node.gen,
                              arc.tensor(gk) if gk in arc else None,
                              arc.tensor(kk) if kk in arc else None)
        if hasattr(node, "host_step"):
            new["host_step"] = int(arc.manifest["step"])
    return _assemble(node, kids, new)


def _assemble(node, kids, new: dict):
    """A container like ``node`` holding the children ``new`` (by the
    names :func:`_children` gave ``kids``; a dataclass also takes any
    other field ``new`` names)."""
    if isinstance(node, dict):
        return {k: new[str(k)] for k in node}
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **new)
    vals = [new[name] for name, _ in kids]
    if hasattr(node, "_fields"):
        return type(node)(*vals)
    return type(node)(vals)


def map_tensors(fn, node):
    """``node`` with ``fn`` applied to every tensor of the port's
    containers; generators, layouts and host counters pass through."""
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        return fn(node) if torch.is_tensor(node) else node
    return _assemble(node, kids, {name: map_tensors(fn, child)
                                  for name, child in kids})


def tensors(node) -> list:
    """Every tensor of the port's containers, in flatten order."""
    out = []
    map_tensors(lambda t: out.append(t) or t, node)
    return out


def restore(workdir: str, step: int, template: Any,
            expect_method: Optional[str] = None):
    """``(tree, manifest)``: ``template``'s structure filled with the
    step's CRC-checked records, each tensor in its template's dtype and
    on its template's device.  ``expect_method`` refuses a manifest
    written by another method (:class:`MethodMismatchError`); manifests
    without a method tag restore as before."""
    arc = _Archive(workdir, step)
    saved = (arc.manifest.get("extra") or {}).get("method")
    if expect_method is not None and saved is not None \
            and saved != expect_method:
        raise MethodMismatchError(
            f"cross-method resume refused: checkpoint at step {step} was "
            f"written by method {saved!r}, this run uses "
            f"{expect_method!r}.  Method states are not interchangeable — "
            f"resume with optimizer={saved!r} or start a fresh workdir.")
    return _rebuild(template, "", arc), arc.manifest


def read_leaves(workdir: str, step: int, keys) -> tuple:
    """``({key: CPU tensor}, manifest)`` for the records ``keys`` names
    (an iterable of keys, or a predicate on each key), CRC-checked —
    the read side of adapter serving."""
    arc = _Archive(workdir, step)
    pred = keys if callable(keys) else (lambda k, _s=set(keys): k in _s)
    return {k: arc.tensor(k) for k in arc.npz.files if pred(k)}, \
        arc.manifest


def restore_latest(workdir: str, template: Any,
                   expect_method: Optional[str] = None):
    """Restore the newest intact step, walking back past damage: a step
    that fails with one of :data:`CORRUPTION_ERRORS` is quarantined and
    the next newest tried; ``(None, None)`` when none is left.  Stale
    tmp directories are reaped first; :class:`MethodMismatchError`
    propagates."""
    clean_stale_tmp(workdir)
    for step in reversed(all_steps(workdir)):
        try:
            return restore(workdir, step, template,
                           expect_method=expect_method)
        except MethodMismatchError:
            raise
        except CORRUPTION_ERRORS as e:
            dst = quarantine(workdir, step)
            print(f"[checkpoint] step {step} failed to restore "
                  f"({type(e).__name__}: {e}); quarantined to {dst}")
    return None, None
