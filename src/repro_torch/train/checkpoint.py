"""Fault-tolerant checkpointing, in the JAX package's file format.

One file per host process per step, ``<dir>/step_<N>/shard_<proc>.ckpt``,
plus an atomically renamed ``MANIFEST`` committing the step; the bytes are
the JAX package's (``repro.train.checkpoint``), so a checkpoint written by
either package restores in the other:

* shard: a ``<QB`` header (payload length, codec), then the payload,
  zstd-compressed (level 3) when ``zstandard`` imports and raw when it does
  not (a reader without it still reads raw shards);
* payload: msgpack of ``{"step", "extra", "arrays"}``, each array
  ``{"dtype", "shape", "crc", "data"}`` under its tree path joined with
  ``/`` (dict keys sorted, list indices), dtype numpy's ``.str`` or
  ``"bfloat16"`` (stored as its uint16 bits), and a crc32 of the data.
  The payload is written and read by this module's own msgpack codec
  (``packb``/``unpackb``: the types the payload uses), so the format does
  not depend on the ``msgpack`` package being installed.

Properties: atomic commit (a step is visible only after its MANIFEST
rename), async save (the device-to-host copy on the caller's thread, the
write on a writer thread), keep-k GC, restore onto any device or mesh, and
per-leaf checksums (a corrupt newest step falls back to the one before).

Over a process group each rank writes ``shard_<rank>``: the blocks of the
tree that it holds, and no block twice. A DTensor leaf's local block is
written by the rank at coordinate 0 of every mesh dim that replicates it,
with its offset in the whole leaf where it is not the whole; any other leaf
by rank 0. Saving issues no collective, so a rank can write its rescue
checkpoint while the others are stuck in a step or gone. Rank 0's payload
and ``MANIFEST`` name the world size; a restore reads every shard of the
step, assembles each leaf whole, and falls back to the step before when a
shard is missing. ``restore_checkpoint(..., shardings=)`` places each leaf
by its ``NamedSharding``, so a checkpoint written on 4 ranks restores onto
2 or 1. On one process the files are the JAX package's, byte for byte.
"""
from __future__ import annotations

import os
import queue
import shutil
import struct
import threading
import zlib
from typing import Any

import numpy as np
import torch

from ..nn.module import tree_leaves, tree_map, tree_unflatten

try:  # compression is optional, as in the JAX package: raw payloads without it
    import zstandard
except ImportError:  # pragma: no cover - exercised on zstd-less machines
    zstandard = None

HAVE_ZSTD = zstandard is not None

MANIFEST = "MANIFEST"

# shard header: <Q raw_len><B codec><payload>. Legacy shards (zstd-only
# format) lack the codec byte; their payload always starts with the zstd
# magic 0x28, which no codec id uses, so readers can tell them apart.
CODEC_RAW = 0
CODEC_ZSTD = 1
_ZSTD_MAGIC_BYTE = 0x28


# ---------------------------------------------------------------------------
# msgpack: the subset the payload uses (nil, bool, int, float, str, bytes,
# list, map), byte for byte what msgpack.packb(obj, use_bin_type=True) writes
# ---------------------------------------------------------------------------


def _head(out: bytearray, n: int, fix: int | None, fix_max: int, codes: tuple[int, ...]):
    """A length or integer header: the fix form when ``n <= fix_max``, else
    the smallest of the 8/16/32-bit forms (``codes``, ``None`` where the
    type has no such form)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack(obj: Any, out: bytearray):
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(obj)
        elif obj >= 0:
            for code, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF),
                                     (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
                if obj <= limit:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise OverflowError(f"integer {obj} too large for msgpack")
        elif obj >= -32:
            out += struct.pack(">b", obj)
        else:
            for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15), (0xD2, ">i", 1 << 31),
                                     (0xD3, ">q", 1 << 63)):
                if obj >= -limit:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    return
            raise OverflowError(f"integer {obj} too small for msgpack")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} into a checkpoint payload")


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack, the bytes of ``msgpack.packb(obj, use_bin_type=True)``."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_FIXED = {  # code -> (struct format, size) of the fixed-width scalars
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTHS = {0xD9: (">B", 1, "str"), 0xDA: (">H", 2, "str"), 0xDB: (">I", 4, "str"),
            0xC4: (">B", 1, "bin"), 0xC5: (">H", 2, "bin"), 0xC6: (">I", 4, "bin"),
            0xDC: (">H", 2, "array"), 0xDD: (">I", 4, "array"), 0xDE: (">H", 2, "map"), 0xDF: (">I", 4, "map")}


def _unpack(buf: memoryview, i: int) -> tuple[Any, int]:
    code = buf[i]
    i += 1
    if code <= 0x7F:
        return code, i
    if code >= 0xE0:
        return code - 0x100, i
    if 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif code in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[code], i
    elif code in _FIXED:
        fmt, size = _FIXED[code]
        return struct.unpack_from(fmt, buf, i)[0], i + size
    elif code in _LENGTHS:
        fmt, size, kind = _LENGTHS[code]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += size
    else:
        raise ValueError(f"msgpack type 0x{code:02x} is not used by checkpoint payloads")
    if kind in ("str", "bin"):
        if i + n > len(buf):
            raise ValueError("truncated msgpack payload")
        data = bytes(buf[i : i + n])
        return (data.decode("utf-8") if kind == "str" else data), i + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            items.append(v)
        return items, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


def unpackb(data: bytes) -> Any:
    """The object of a msgpack message (``msgpack.unpackb(data, raw=False)``
    for the types ``packb`` writes, and float32)."""
    buf = memoryview(data)
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the msgpack payload")
    return obj


# ---------------------------------------------------------------------------
# arrays
# ---------------------------------------------------------------------------


def _paths(tree, prefix: str = "") -> list[str]:
    """Leaf keys in ``tree_leaves`` order: the tree path of each leaf, dict
    keys and list indices joined with ``/`` (the JAX package's ``_flatten``)."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree) for q in _paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def _host(x) -> torch.Tensor:
    """A leaf as a CPU tensor that owns its memory."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(x, copy=True))


def _block(x, writes_whole: bool):
    """(this rank's block of leaf ``x`` as a CPU tensor, its offset in the
    whole leaf or None where it is the whole), or None where another rank
    writes it. No collective: a DTensor's local block, written by the rank
    at coordinate 0 of each mesh dim that replicates it; any other leaf
    where ``writes_whole``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return (_host(x), None) if writes_whole else None
    if not all(isinstance(p, (Shard, Replicate)) for p in x.placements):
        raise ValueError(f"cannot checkpoint a leaf placed {x.placements}")
    coord = x.device_mesh.get_coordinate()
    if any(isinstance(p, Replicate) and c for p, c in zip(x.placements, coord)):
        return None
    local = _host(x.to_local())
    if tuple(local.shape) == tuple(x.shape):
        return local, None
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return local, tuple(compute_local_shape_and_global_offset(x.shape, x.device_mesh, x.placements)[1])


def _pack_array(t: torch.Tensor) -> dict:
    if t.dtype == torch.bfloat16:  # stored as its uint16 bits, as the JAX package stores it
        data, dtype = t.view(torch.int16).numpy().view(np.uint16).tobytes(), "bfloat16"
    else:
        a = t.numpy()
        data, dtype = a.tobytes(), a.dtype.str
    return {"dtype": dtype, "shape": list(t.shape), "crc": zlib.crc32(data), "data": data}


def _unpack_array(d: dict) -> torch.Tensor:
    data = d["data"]
    if zlib.crc32(data) != d["crc"]:
        raise IOError("checkpoint leaf checksum mismatch")
    if d["dtype"] == "bfloat16":
        bits = np.frombuffer(data, np.uint16).reshape(d["shape"]).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(data, np.dtype(d["dtype"])).reshape(d["shape"]).copy())


def _host_copy(tree: Any, process_index: int = 0, n_processes: int = 1) -> dict:
    """``{path: (block, offset)}`` of the leaves this rank writes, each
    block copied to host memory (the JAX package's ``jax.device_get``): a
    copy, so a step that later writes into the device buffers
    (``AdamW.update_``) cannot change what is saved."""
    out = {}
    for key, x in zip(_paths(tree), tree_leaves(tree)):
        blk = _block(x, n_processes == 1 or process_index == 0)
        if blk is None:
            continue
        if blk[1] is not None and n_processes == 1:
            raise ValueError(f"leaf {key} is sharded over ranks: save it with n_processes")
        out[key] = blk
    return out


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, extra: dict | None = None, process_index: int = 0,
                    n_processes: int = 1):
    """Synchronous save of a tree of tensors, DTensors or arrays
    (``AsyncCheckpointer`` saves on a writer thread)."""
    return _write(ckpt_dir, step, _host_copy(tree, process_index, n_processes), extra, process_index, n_processes)


def _write(ckpt_dir: str, step: int, blocks: dict, extra, process_index: int, n_processes: int) -> str:
    step_dir = os.path.join(ckpt_dir, f"step_{step:010d}")
    os.makedirs(step_dir, exist_ok=True)
    arrays = {}
    for key, (t, offset) in blocks.items():
        arrays[key] = _pack_array(t)
        if offset is not None:
            arrays[key]["offset"] = list(offset)
    payload = {"step": step, "extra": extra or {}, "arrays": arrays}
    if n_processes > 1:
        payload["n_processes"] = n_processes
    raw = packb(payload)
    if HAVE_ZSTD:
        codec, data = CODEC_ZSTD, zstandard.ZstdCompressor(level=3).compress(raw)
    else:
        codec, data = CODEC_RAW, raw
    shard = os.path.join(step_dir, f"shard_{process_index:05d}.ckpt")
    tmp = shard + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<QB", len(raw), codec))
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, shard)
    # commit: the manifest names the step (process 0 only on multihost)
    if process_index == 0:
        mtmp = os.path.join(ckpt_dir, MANIFEST + ".tmp")
        with open(mtmp, "w") as f:
            f.write(f"{step}\n{n_processes}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, os.path.join(ckpt_dir, MANIFEST))
    return shard


def _load_shard(path: str) -> dict:
    with open(path, "rb") as f:
        rawlen = struct.unpack("<Q", f.read(8))[0]
        head = f.read(1)
        body = f.read()
    if not head:
        raise IOError(f"truncated checkpoint shard {path}")
    codec = head[0]
    if codec == _ZSTD_MAGIC_BYTE:  # legacy shard: payload starts right here
        codec, body = CODEC_ZSTD, head + body
    if codec == CODEC_RAW:
        raw = body
    elif codec == CODEC_ZSTD:
        if not HAVE_ZSTD:
            raise IOError(f"{path} is zstd-compressed but zstandard is not installed")
        raw = zstandard.ZstdDecompressor().decompress(body, max_output_size=rawlen)
    else:
        raise IOError(f"unknown checkpoint codec {codec} in {path}")
    if len(raw) != rawlen:
        raise IOError(f"checkpoint payload length mismatch in {path}")
    return unpackb(raw)


def available_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                pass
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    mpath = os.path.join(ckpt_dir, MANIFEST)
    if os.path.exists(mpath):
        with open(mpath) as f:
            return int(f.readline())
    steps = available_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, template: Any, step: int | None = None, device=None, shardings: Any = None,
                       process_index: int = 0):
    """Restore into the structure of ``template`` (a tree whose leaves have
    ``.shape``: tensors, DTensors, meta tensors or arrays) as tensors of the
    saved dtypes, on ``device``, or each on its template leaf's device (the
    CPU for an array or a meta tensor); with ``shardings`` (a tree of
    ``dist.NamedSharding`` of the template's structure) each leaf is placed
    by its sharding instead, on whatever mesh it names. Returns ``(tree,
    step, extra)``. Without ``step``, the newest step first, falling back to
    the one before when a shard is corrupt, partial or does not fit the
    template."""
    candidates = [step] if step is not None else list(reversed(available_steps(ckpt_dir)))
    leaves, keys = tree_leaves(template), _paths(template)
    last_err = None
    for s in candidates:
        step_dir = os.path.join(ckpt_dir, f"step_{s:010d}")
        try:
            payload = _load_shard(os.path.join(step_dir, f"shard_{process_index:05d}.ckpt"))
            n = payload.get("n_processes", 1)
            payloads = [payload]
            if n > 1:  # a multi-process layout: every rank's blocks
                payloads = [_load_shard(os.path.join(step_dir, f"shard_{r:05d}.ckpt")) for r in range(n)]
            out = []
            for key, leaf in zip(keys, leaves):
                a = _assemble(payloads, key, tuple(leaf.shape))
                out.append(a if shardings is not None else a.to(device if device is not None else _home(leaf)))
            tree = tree_unflatten(template, out)
        except Exception as e:  # corrupt / partial / mismatched -> try older
            last_err = e
            continue
        if shardings is not None:
            from ..dist.sharding import device_put

            tree = device_put(tree, shardings)
        return tree, payload["step"], payload.get("extra", {})
    raise FileNotFoundError(f"no restorable checkpoint in {ckpt_dir}: {last_err}")


def _assemble(payloads: list[dict], key: str, shape: tuple) -> torch.Tensor:
    """Leaf ``key`` whole, from the blocks the shards hold of it."""
    entries = [pl["arrays"][key] for pl in payloads if key in pl["arrays"]]
    if not entries:
        raise KeyError(f"checkpoint missing leaf {key}")
    if len(entries) == 1 and "offset" not in entries[0]:
        a = _unpack_array(entries[0])
        if tuple(a.shape) != shape:
            raise ValueError(f"shape mismatch for {key}: {tuple(a.shape)} vs {shape}")
        return a
    out, covered = None, 0
    for e in entries:
        a = _unpack_array(e)
        offset = e.get("offset", [0] * len(shape))
        index = tuple(slice(o, o + n) for o, n in zip(offset, a.shape))
        if out is None:
            out = torch.empty(shape, dtype=a.dtype)
        if out[index].shape != a.shape:
            raise ValueError(f"block of {key} at {offset} {tuple(a.shape)} does not fit {shape}")
        out[index] = a
        covered += a.numel()
    if covered != out.numel():
        raise ValueError(f"the blocks of {key} cover {covered} of its {out.numel()} elements")
    return out


def _home(leaf) -> torch.device:
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        return leaf.device
    return torch.device("cpu")


def gc_checkpoints(ckpt_dir: str, keep: int = 3):
    steps = available_steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"), ignore_errors=True)


class AsyncCheckpointer:
    """Background writer thread; the train loop only pays the device-to-host
    copy. ``process_index`` names this rank's shard, and rank 0's manifest
    names ``n_processes``."""

    def __init__(self, ckpt_dir: str, keep: int = 3, process_index: int = 0, n_processes: int = 1):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.process_index = process_index
        self.n_processes = n_processes
        self.q: queue.Queue = queue.Queue(maxsize=2)
        self.errors: list[Exception] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            item = self.q.get()
            try:
                if item is None:
                    return
                step, blocks, extra = item
                _write(self.ckpt_dir, step, blocks, extra, self.process_index, self.n_processes)
                gc_checkpoints(self.ckpt_dir, self.keep)
            except Exception as e:  # surfaced by wait()
                self.errors.append(e)
            finally:
                self.q.task_done()

    def save(self, step: int, tree: Any, extra: dict | None = None):
        # synchronous copy of this rank's blocks, no collective; the write is async
        self.q.put((step, _host_copy(tree, self.process_index, self.n_processes), extra))

    def wait(self):
        """Block until all queued saves are durable; surface writer errors."""
        self.q.join()
        if self.errors:
            raise self.errors[0]

    def close(self):
        self.wait()
        self.q.put(None)
        self._thread.join(timeout=10)
