"""Weights files: npz / safetensors ⇄ parameter pytrees (numpy only).

The port's own copy of the JAX package's ``models/params_io.py``, byte
for byte in what it writes, so a file written by either package reads
back identically in the other:

- ``.npz``: numpy archive with ``/``-joined pytree paths as keys and the
  metadata as a JSON blob under ``__nns_meta__``.
- ``.safetensors``: hand-rolled reader/writer for the HuggingFace weight
  format (8-byte LE header length + JSON header + raw little-endian
  tensor bytes), the metadata strings under ``__metadata__``.

Path segments: dict keys holding the separator are ``\\``-escaped, list
indices are ``#i`` segments.  Scalar leaves are stored as 0-d arrays and
come back as python scalars from npz; safetensors stores them as
1-element arrays (in both packages).  Both formats carry the model-file metadata
the ``torch-cuda`` filter reads (``apply`` "module:callable", input
shapes/dtypes), so a weights file loads with ``tensor_filter
model=weights.safetensors``.  The port adds one optional key,
``apply_kwargs`` (a JSON object bound to ``apply`` by keyword), which the
JAX package's reader carries along unread.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# -- pytree ⇄ flat dict -------------------------------------------------------


def _escape_seg(key: str, sep: str) -> str:
    """Escape a dict key so it survives as one path segment even when it
    contains the separator."""
    return key.replace("\\", "\\\\").replace(sep, "\\" + sep)


def _split_path(path: str, sep: str) -> List[str]:
    """Split on unescaped separators and unescape each segment — the
    inverse of :func:`_escape_seg` applied per segment."""
    parts: List[str] = []
    cur: List[str] = []
    i, n, w = 0, len(path), len(sep)
    while i < n:
        c = path[i]
        if c == "\\" and i + 1 < n:
            cur.append(path[i + 1])
            i += 2
            continue
        if path.startswith(sep, i):
            parts.append("".join(cur))
            cur = []
            i += w
            continue
        cur.append(c)
        i += 1
    parts.append("".join(cur))
    return parts


def flatten_params(params: Any, sep: str = "/") -> Dict[str, np.ndarray]:
    """Flatten a nested dict/list/tuple pytree of arrays into
    ``{"path/to/leaf": ndarray}``.  List/tuple indices become ``#i``
    segments (distinct from digit-string dict keys); dict keys holding
    the separator are backslash-escaped; non-array leaves are stored as
    0-d arrays."""
    out: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node: Any) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                seg = _escape_seg(str(k), sep)
                walk(f"{prefix}{sep}{seg}" if prefix else seg, v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                seg = f"#{i}"
                walk(f"{prefix}{sep}{seg}" if prefix else seg, v)
        else:
            out[prefix] = np.asarray(node)

    walk("", params)
    return out


def unflatten_params(flat: Dict[str, np.ndarray], sep: str = "/",
                     escaped: bool = True) -> Any:
    """Inverse of :func:`flatten_params`: ``#i`` segments rebuild lists,
    digit keys stay dict keys, escaped separators stay in their segment,
    0-d arrays come back as python scalars.  ``escaped=False`` reads the
    older v2 layout (plain split, backslashes literal)."""
    root: Dict = {}
    for path, leaf in flat.items():
        parts = _split_path(path, sep) if escaped else path.split(sep)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf.item() if leaf.ndim == 0 else leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.startswith("#") and k[1:].isdigit()
                        for k in keys):
            return [fix(node[k]) for k in sorted(keys,
                                                 key=lambda k: int(k[1:]))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


# -- npz ----------------------------------------------------------------------

_META_KEY = "__nns_meta__"


def save_npz(path: str, params: Any, apply: Optional[str] = None,
             in_shapes: Optional[Sequence] = None,
             in_dtypes: Any = None,
             apply_kwargs: Optional[Dict[str, Any]] = None) -> str:
    """Write a pytree as .npz; ``apply`` ("module:callable"), its
    ``apply_kwargs`` and the input schema ride along so the file works
    as a tensor_filter model."""
    flat = flatten_params(params)
    meta = {"apply": apply, "in_shapes": in_shapes,
            "in_dtypes": np.dtype(in_dtypes).name
            if in_dtypes is not None else None,
            # v3 = backslash-escaped separators inside dict-key segments
            "format": "nns-params-v3"}
    if apply_kwargs is not None:
        meta["apply_kwargs"] = dict(apply_kwargs)
    flat[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), np.uint8)
    np.savez(path, **flat)
    return path


def load_npz(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Returns (params pytree, metadata dict)."""
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta: Dict[str, Any] = {}
    blob = flat.pop(_META_KEY, None)
    if blob is not None:
        meta = json.loads(bytes(blob.tobytes()).decode("utf-8"))
    return unflatten_params(
        flat, escaped=meta.get("format") == "nns-params-v3"), meta


# -- safetensors --------------------------------------------------------------

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}


def _st_name(dt: np.dtype) -> str:
    if dt.name == "bfloat16":
        return "BF16"
    for name, np_t in _ST_DTYPES.items():
        if np.dtype(np_t) == dt:
            return name
    raise ValueError(f"safetensors: unsupported dtype {dt}")


def _st_np(name: str):
    if name == "BF16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    try:
        return np.dtype(_ST_DTYPES[name])
    except KeyError:
        raise ValueError(f"safetensors: unsupported dtype {name!r}") \
            from None


def save_safetensors(path: str, params: Any,
                     metadata: Optional[Dict[str, str]] = None) -> str:
    """Write a pytree in safetensors layout (sorted keys, little-endian
    raw bytes, ``__metadata__`` for the apply/schema strings)."""
    flat = flatten_params(params)
    header: Dict[str, Any] = {}
    md = {str(k): str(v) for k, v in (metadata or {}).items()}
    md.setdefault("format", "nns-params-v3")
    header["__metadata__"] = md
    off = 0
    chunks: List[bytes] = []
    for name in sorted(flat):
        arr = np.ascontiguousarray(flat[name])
        raw = arr.tobytes()
        header[name] = {"dtype": _st_name(arr.dtype),
                        "shape": list(arr.shape),
                        "data_offsets": [off, off + len(raw)]}
        chunks.append(raw)
        off += len(raw)
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for c in chunks:
            f.write(c)
    return path


def load_safetensors(path: str) -> Tuple[Any, Dict[str, str]]:
    """Returns (params pytree, metadata dict).  Validates offsets
    against the file size before touching tensor bytes."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        (hlen,) = struct.unpack("<Q", f.read(8))
        if hlen > size - 8:
            raise ValueError(f"safetensors: header length {hlen} exceeds "
                             f"file size {size}")
        header = json.loads(f.read(hlen).decode("utf-8"))
        base = 8 + hlen
        meta = header.pop("__metadata__", {}) or {}
        flat: Dict[str, np.ndarray] = {}
        for name, desc in header.items():
            dt = _st_np(desc["dtype"])
            lo, hi = desc["data_offsets"]
            nbytes = int(np.prod(desc["shape"], dtype=np.int64)) * \
                dt.itemsize if desc["shape"] else dt.itemsize
            if lo < 0 or hi < lo or hi - lo != nbytes or \
                    base + hi > size:
                raise ValueError(
                    f"safetensors: bad offsets for {name!r}")
            f.seek(base + lo)
            flat[name] = np.frombuffer(
                f.read(hi - lo), dt).reshape(desc["shape"]).copy()
    # only v3 files escape separators; v2 files and files from other
    # tools (whose names may carry literal backslashes) use a plain split
    return unflatten_params(
        flat, escaped=meta.get("format") == "nns-params-v3"), dict(meta)
