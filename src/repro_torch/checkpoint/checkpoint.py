"""Sharded, elastic, async checkpointing: the JAX package's
``repro.checkpoint`` on torch tensors, in its on-disk format.

Layout per step:  <dir>/step_<n>/
    manifest.json   — step, per-leaf shapes, dtypes and partition specs
    arrays.npz      — logical (unsharded) array contents, flat-key indexed

* **Atomicity** — writes land in ``step_<n>.tmp`` and are renamed only when
  complete; :func:`latest_step` scans for the newest *complete* step.
* **Elasticity** — arrays are stored in logical layout plus their spec;
  restore re-lays them onto any mesh by the spec cleaned for it
  (:func:`clean_spec`).
* **Async** — :class:`AsyncCheckpointer` snapshots the tensors to host
  memory before ``save`` returns and writes on a background thread,
  overlapping the I/O with the next train steps; ``wait()`` joins.

A tree is a nesting of dicts (flattened in sorted key order, as JAX
flattens them), lists and tuples (by index), with tensors, DTensors, numpy
arrays or numbers as leaves; ``None`` is an empty subtree. A leaf's flat key
is its path joined by ``/``: the JAX tree's key when the tree has the JAX
nesting (``params/layers/ffn/w1``, ``opt/m/embed``, ``opt/step``), which
the trainer builds with ``models.transformer.model.params_tree`` and
``optim.opt_state_tree``.

bfloat16, which numpy lacks, is written as the JAX package writes its
``ml_dtypes`` arrays: the 2-byte patterns under a ``'<V2'`` header, and
``"bfloat16"`` in the manifest. Each leaf is read back by the manifest's
dtype (the JAX package's own restore rejects that leaf: ROADMAP §C,
quirks of the reference). A DTensor leaf is saved whole (a gather over
its mesh) with its spec, and only the process of rank 0 writes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import struct
import threading
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import sharding as shd

#: the ``.npy`` header descr of a bfloat16 array, as numpy writes
#: ``ml_dtypes.bfloat16`` (numpy's own ``V2`` would read ``'|V2'``)
_BF16_DESCR = "<V2"
#: bytes per write into the archive, as ``numpy.lib.format.write_array``
_CHUNK = 16 << 20
#: threads that check a member's CRC-32 on restore (the chip machine's cores)
_CRC_THREADS = 8


# --------------------------------------------------------------------------
# trees


def _flatten(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``[(flat key, leaf)]`` in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _unflatten(tree, leaves: Iterator[Any]):
    """``tree``'s structure with its leaves replaced, in flatten order."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        out = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def tree_map(fn, tree):
    """``fn`` over every leaf of ``tree``, in its structure."""
    return _unflatten(tree, iter([fn(leaf) for _, leaf in _flatten(tree)]))


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _host(leaf) -> torch.Tensor:
    """A leaf as a CPU tensor (a DTensor gathered whole)."""
    if isinstance(leaf, torch.Tensor):
        if _is_dtensor(leaf):
            leaf = leaf.full_tensor()
        return leaf.detach().cpu()
    return torch.from_numpy(np.array(leaf))


def _spec_str(leaf) -> str:
    if not _is_dtensor(leaf):
        return ""
    return json.dumps([list(p) if isinstance(p, tuple) else p for p in shd.spec_of(leaf)])


# --------------------------------------------------------------------------
# the array file


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str, str]:
    """``(array, npy descr, manifest dtype)`` of a CPU tensor, no copy."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), _BF16_DESCR, "bfloat16"
    arr = t.numpy()
    return arr, np.lib.format.dtype_to_descr(arr.dtype), str(arr.dtype)


def _write_npz(path: Path, arrays: Sequence[Tuple[str, np.ndarray, str]]):
    """``np.savez``'s archive (stored, zip64 members ``<key>.npy``) with
    each member's header descr given."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr, descr in arrays:
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                np.lib.format.write_array_header_1_0(
                    fid, {"descr": descr, "fortran_order": False, "shape": arr.shape})
                flat = arr.reshape(-1).view(np.uint8)
                for lo in range(0, flat.size, _CHUNK):
                    fid.write(flat[lo:lo + _CHUNK])


def _gf2_times(mat: List[int], vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_square(mat: List[int]) -> List[int]:
    return [_gf2_times(mat, row) for row in mat]


def _crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """The CRC-32 of ``a + b`` from ``crc32(a)``, ``crc32(b)`` and ``len(b)``
    (zlib's ``crc32_combine``, which Python's ``zlib`` does not expose)."""
    if len2 == 0:
        return crc1
    odd = [0xEDB88320] + [1 << n for n in range(31)]  # one zero bit
    even = _gf2_square(odd)  # two
    odd = _gf2_square(even)  # four
    while True:
        even = _gf2_square(odd)
        if len2 & 1:
            crc1 = _gf2_times(even, crc1)
        len2 >>= 1
        if not len2:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times(odd, crc1)
        len2 >>= 1
        if not len2:
            break
    return crc1 ^ crc2


def _crc32(buf: memoryview, start: int = 0) -> int:
    """``zlib.crc32(buf, start)`` with the chunks in threads (zlib releases
    the interpreter lock), combined."""
    step = max(-(-len(buf) // _CRC_THREADS), 64 << 20)
    chunks = [buf[lo:lo + step] for lo in range(0, len(buf), step)]
    if len(chunks) < 2:
        return zlib.crc32(buf, start)
    with ThreadPoolExecutor(len(chunks)) as ex:
        crcs = list(ex.map(zlib.crc32, chunks))
    for c, chunk in zip(crcs, chunks):
        start = _crc32_combine(start, c, len(chunk))
    return start


class _NpzReader:
    """The members of an ``np.savez`` archive, each read straight into its
    array (one read, the CRC-32 checked in threads): ``np.load``'s arrays
    at the file system's rate. A member that is compressed, Fortran-ordered
    or of another header version is read by ``numpy.lib.format``."""

    def __init__(self, path: Path):
        self._zip = zipfile.ZipFile(path)
        self._file = open(path, "rb")
        self._info = {i.filename[:-4]: i for i in self._zip.infolist()
                      if i.filename.endswith(".npy")}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._file.close()
        self._zip.close()

    def __contains__(self, key: str) -> bool:
        return key in self._info

    def __getitem__(self, key: str) -> np.ndarray:
        info, f = self._info[key], self._file
        f.seek(info.header_offset)
        local = f.read(30)
        if local[:4] != b"PK\x03\x04":
            raise zipfile.BadZipFile(f"bad local header for {info.filename}")
        start = info.header_offset + 30 + sum(struct.unpack("<HH", local[26:30]))
        f.seek(start)
        version = (np.lib.format.read_magic(f)
                   if info.compress_type == zipfile.ZIP_STORED else None)
        if version in ((1, 0), (2, 0)):
            read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
        if version not in ((1, 0), (2, 0)) or fortran or dtype.hasobject:
            with self._zip.open(info) as member:
                return np.lib.format.read_array(member)
        head = f.tell() - start
        arr = np.empty(shape, dtype)
        view = memoryview(arr.reshape(-1).view(np.uint8))
        got = 0
        while got < len(view):
            n = f.readinto(view[got:])
            if not n:
                raise zipfile.BadZipFile(f"{info.filename} is truncated")
            got += n
        f.seek(start)
        crc = _crc32(view, zlib.crc32(f.read(head)))
        if head + got != info.file_size or crc != info.CRC:
            raise zipfile.BadZipFile(f"Bad CRC-32 for file {info.filename!r}")
        return arr


def _from_npz(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded leaf as a CPU tensor of the manifest's ``dtype``."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


# --------------------------------------------------------------------------
# save / restore


def save_checkpoint(
    directory: str | os.PathLike,
    step: int,
    tree,
    extra_meta: Optional[Dict] = None,
) -> Path:
    """Synchronous atomic checkpoint write. Returns the final path."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    flat = _flatten(tree)
    host = [(k, _to_numpy(_host(v)), _spec_str(v)) for k, v in flat]
    if any(_is_dtensor(v) for _, v in flat) and dist.get_rank() != 0:
        return final  # every rank gathered; rank 0 writes
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {
        "step": step,
        "keys": {
            k: {"shape": list(arr.shape), "dtype": dtype, "spec": spec}
            for k, (arr, _, dtype), spec in host
        },
        "extra": extra_meta or {},
    }
    _write_npz(tmp / "arrays.npz", [(k, arr, descr) for k, (arr, descr, _), _ in host])
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str | os.PathLike) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    best = None
    for p in directory.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "manifest.json").exists():
            best = max(best or -1, int(m.group(1)))
    return best


def clean_spec(spec: Sequence[Any], shape: Sequence[int], mesh) -> shd.PartitionSpec:
    """A saved spec cleaned for ``mesh``: each dimension keeps its entry
    only if every axis it names is on ``mesh``, the dimension exists and
    the axes' size product divides it; otherwise it is replicated (the
    JAX package's rule, ``repro.checkpoint.checkpoint.restore_checkpoint``;
    there an axis the mesh lacks raises ``KeyError`` instead: ROADMAP §C)."""
    clean = []
    for dim, p in enumerate(spec):
        axes = (tuple(a for a in (p if isinstance(p, tuple) else (p,)) if a is not None)
                if p is not None else ())
        ok = all(a in mesh.shape for a in axes)
        size = int(np.prod([mesh.shape[a] for a in axes])) if axes and ok else 1
        ok = ok and dim < len(shape) and size and shape[dim] % size == 0
        clean.append(p if (ok and axes) else None)
    return shd.P(*clean)


def _parse_spec(spec_json: str) -> List[Any]:
    return [tuple(p) if isinstance(p, list) else p for p in json.loads(spec_json)]


def _device(leaf) -> torch.device:
    if isinstance(leaf, torch.Tensor) and not _is_dtensor(leaf):
        return leaf.device
    return torch.device("cpu")


def restore_checkpoint(
    directory: str | os.PathLike,
    target_tree,
    step: Optional[int] = None,
    mesh=None,
    sharding_fn=None,
) -> Tuple[Any, int, Dict]:
    """Restore into the structure of ``target_tree``.

    Without ``mesh`` each leaf is a tensor on the device of the target's
    leaf (the CPU for a host snapshot: no copy). With ``mesh`` the
    manifest's spec, cleaned for it (or ``sharding_fn(key, tensor) ->
    NamedSharding``), places each leaf (``dist.sharding.device_put``): on a
    multi-rank mesh a DTensor of this rank's slice — the elastic path: the
    stored layout is logical, so any rank count works.
    """
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    out = []
    with _NpzReader(d / "arrays.npz") as data:
        for key, leaf in _flatten(target_tree):
            if key not in data:
                raise KeyError(f"checkpoint missing key {key!r}")
            meta = manifest["keys"][key]
            t = _from_npz(data[key], meta["dtype"])
            if mesh is not None:
                if sharding_fn is not None:
                    sh = sharding_fn(key, t)
                else:
                    spec = _parse_spec(meta["spec"]) if meta["spec"] else ()
                    sh = shd.NamedSharding(mesh, clean_spec(spec, t.shape, mesh))
                t = shd.device_put(t, sh)
            else:
                t = t.to(_device(leaf))
            out.append(t)
    return _unflatten(target_tree, iter(out)), step, manifest.get("extra", {})


class AsyncCheckpointer:
    """Background-thread checkpoint writer (overlaps I/O with training).

    ``save`` copies every leaf into host buffers before it returns, so the
    caller may update its tensors in place right after (the port's train
    step does). The buffers are kept and reused by the next save, once the
    write before it has been joined."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._buffers: Dict[str, torch.Tensor] = {}

    def _snapshot(self, tree):
        host = []
        for key, leaf in _flatten(tree):
            if not isinstance(leaf, torch.Tensor) or _is_dtensor(leaf):
                host.append(_host(leaf).clone())
                continue
            buf = self._buffers.get(key)
            if buf is None or buf.shape != leaf.shape or buf.dtype != leaf.dtype:
                buf = self._buffers[key] = torch.empty(leaf.shape, dtype=leaf.dtype)
            host.append(buf.copy_(leaf.detach()))  # a synchronous copy off a card
        return _unflatten(tree, iter(host))

    def save(self, step: int, tree, extra_meta=None):
        self.wait()
        host_tree = self._snapshot(tree)

        def _write():
            try:
                save_checkpoint(self.directory, step, host_tree, extra_meta)
                self._gc()
            except BaseException as e:  # surfaced at next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(m.group(1))
            for p in self.directory.iterdir()
            if (m := re.fullmatch(r"step_(\d+)", p.name))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}", ignore_errors=True)
