"""The JAX package's orbax steps read by the port, without orbax, on the CPU.

1. The zstd decoder (``native/nns_zstd.cc`` through ``nativelib.py``)
   against ``zstandard``: hypothesis inputs of 0 B to 1 MB at levels 1, 3
   and 19, with and without the checksum and the content size,
   multi-block frames; raw- and RLE-only frames, skippable and
   concatenated frames; truncated and bit-flipped frames return an error
   (a flipped frame with a checksum errors, or decodes to the original
   where the flip hit a bit the decoder does not read).
1b. The blosc decoder (``native/nns_blosc.cc``) against tensorstore's
   blosc: every cname (blosclz, lz4, lz4hc, snappy, zlib, zstd) x no
   shuffle, byte shuffle, bitshuffle x element sizes 1 to 8, frames over
   several blocks, raw streams, memcpyed frames; truncated frames and
   headers or block tables out of bounds raise, flipped bits raise or
   decode to the declared size.
2. The OCDBT store (``trainers/ocdbt.py``) against tensorstore's own
   reads, on a store with interior nodes and inline and indirect values,
   and on stores with numbered manifests (with and without zstd nodes);
   damaged nodes and manifests, and another store's numbered manifest,
   raise.
3. Steps the JAX package writes (``save_orbax``), each leaf held bit for
   bit against ``orbax.checkpoint.StandardCheckpointer().restore``: every
   dtype, 0-d and Python scalars, nested dicts and lists, empty nodes;
   sharded and replicated leaves on the 8 virtual devices (several chunks
   a leaf); a ``use_ocdbt=False`` save; a JAX ``tensor_trainer`` step;
   templates (dtype casts; a structure mismatch raises where orbax
   raises; a shape mismatch keeps the stored shape, as orbax does).
4. The tests' writer (``tests/torch_orbax_files.py``: the package's
   encoder with per-leaf chunk shapes and missing chunks) held against
   orbax's restore: a chunk grid that does not divide the shape, missing
   chunks, bf16 torch leaves.
5. The committed step ``tests/data/orbax_step/`` (JAX ``save_orbax`` of
   ``torch_orbax_files.fixture_tree()``): multi-block frames with Huffman
   literals and FSE sequences, read bit-equal to the seeded tree.
6. The other forms orbax's restore reads, each leaf bit-equal to it
   (every dtype read, complex and big-endian included): tensorstore's
   zarr v2 compressors (zlib, gzip, bz2, blosc with each cname and
   shuffle), order F, big-endian dtypes; zarr v3 (orbax's ``use_zarr3``,
   and tensorstore's codec chains: ``bytes`` either endian,
   ``transpose``, ``zstd``, ``gzip``, ``blosc``, ``crc32c``,
   ``sharding_indexed`` with inner chunks, the index at the start or the
   end, with and without its CRC, nested; each chunk key encoding; NaN,
   Infinity and hex fill values), with and without a template, over
   OCDBT and per-file stores.  Refusals, each naming its field: a zarr v2
   compressor tensorstore does not write, ``filters``, malformed
   metadata, unread dtypes; a zarr v3 codec not read, a non-regular grid,
   another chunk key encoding, storage transformers; damaged shards; a
   directory of neither format.
7. The port's writer (``trainers/orbax_write.py``, ``save_dir`` and
   ``save_step``): orbax's restore (the JAX package's ``load_orbax``)
   reads every leaf it writes bit for bit, with and without a template,
   as it reads the same tree saved by the JAX package — every dtype the
   reader reads, bf16 torch tensors, 0-d arrays, Python scalars, nested
   lists, empty nodes —, a trained MobileNetV1 tree, a leaf split over
   ``model`` written a chunk a slice; the port's reader reads each such
   step equal to what was written; the writer writes only zarr v2 +
   zstd + order C (the forms it does not write read as orbax reads them,
   lz4 and filters stay refused);
   a step root written half by each package, where both packages'
   ``latest_step`` pick the highest step; the write replaces a step
   whole and leaves nothing hidden behind.
8. A step written across ranks, made in one process: each rank's share
   (``held``, ``plan``, ``share``) in its ``ocdbt.process_<rank>/``
   store, merged (``merge_stores``) and read by orbax's restore and the
   port's reader bit for bit, two and four ranks; each chunk in one
   store; a rank's share left out fails the read; the plan's refusals; a
   slice split over its holders; a group of one rank writes as one
   process.  Across real processes: ``test_torch_training_multihost.py``.
9. The committed forms ``tests/data/orbax_forms/<form>/``
   (``torch_orbax_files.regenerate_forms()``): each the form it names, at
   most 256 KB (1.5 MB in all), read bit-equal to its seeded tree and to
   orbax's restore; the tests' zarr v3 writer (``form="zarr3"``) read by
   orbax's restore and the port's reader bit for bit.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

import torch_orbax_files as W
from nnstreamer_tpu.trainers import checkpoint as jck
from nnstreamer_tpu.trainers.checkpoint import load_orbax as jload_orbax
from nnstreamer_tpu.trainers.checkpoint import save_orbax
from nnstreamer_tpu_torch import nativelib
from nnstreamer_tpu_torch.trainers import checkpoint as tck
from nnstreamer_tpu_torch.trainers.ocdbt import Ocdbt, OcdbtError
from nnstreamer_tpu_torch.trainers import orbax_write as OW
from nnstreamer_tpu_torch.trainers.orbax_format import (OrbaxFormatError,
                                                        load_orbax)

zstandard = pytest.importorskip("zstandard")


# -- helpers -------------------------------------------------------------------


def restore(path, template=None):
    """orbax's own restore (the JAX package's ``load_orbax``)."""
    return jload_orbax(str(path), template)


def assert_same(got, want, where="tree"):
    """``got`` (the port's) equals orbax's ``want`` bit for bit, in the
    same structure and dtypes; bf16 leaves are torch.bfloat16 tensors."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}.{i}")
    elif want is None:
        assert got is None, where
    elif isinstance(want, (bool, int, float)):
        assert type(got) is type(want) and got == want, (where, got, want)
    else:
        w = np.asarray(want)
        if w.dtype.name == "bfloat16":
            assert isinstance(got, torch.Tensor), where
            assert got.dtype == torch.bfloat16, where
            g, w = got.view(torch.int16).numpy(), w.view(np.int16)
        else:
            assert isinstance(got, np.ndarray), (where, type(got))
            g = got
        assert g.dtype == w.dtype, (where, g.dtype, w.dtype)
        assert g.shape == w.shape, (where, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), where


def zdecode(frame: bytes, size=None) -> bytes:
    return nativelib.zstd_decompress(frame, size).tobytes()


def frame_blocks(frame: bytes):
    """(block type, literals type, sequence modes) of each block of a
    zstd frame: type 0 raw, 1 RLE, 2 compressed; literals 0 raw, 1 RLE,
    2 Huffman, 3 treeless; modes (LL, OF, ML), 2 = FSE-coded."""
    fhd = frame[4]
    single, fcs, did = fhd >> 5 & 1, fhd >> 6, fhd & 3
    pos = 5 + (0 if single else 1) + (0, 1, 2, 4)[did] + \
        ((1 if single else 0), 2, 4, 8)[fcs]
    out = []
    while True:
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        pos += 3
        last, kind, size = bh & 1, bh >> 1 & 3, bh >> 3
        if kind != 2:
            out.append((kind, None, None))
            pos += 1 if kind == 1 else size
        else:
            b = frame[pos:pos + size]
            ltype, sfmt = b[0] & 3, b[0] >> 2 & 3
            if ltype < 2:
                hs = (1, 2, 1, 3)[sfmt]
                h = int.from_bytes(b[:hs], "little")
                regen = h >> 3 if hs == 1 else h >> 4
                lit = hs + (regen if ltype == 0 else 1)
            else:
                hs = (3, 3, 4, 5)[sfmt]
                bits = (10, 10, 14, 18)[sfmt]
                h = int.from_bytes(b[:hs], "little")
                lit = hs + (h >> (4 + bits) & ((1 << bits) - 1))
            n0 = b[lit]
            q = lit + (1 if n0 < 128 else 2 if n0 < 255 else 3)
            modes = None if n0 == 0 else (b[q] >> 6, b[q] >> 4 & 3,
                                          b[q] >> 2 & 3)
            out.append((2, ltype, modes))
            pos += size
        if last:
            return out


def payload(kind: int, n: int, seed: int) -> bytes:
    """Seeded bytes of one of five kinds: uniform, a 4-letter alphabet,
    float32 normals, quarter-step floats (long repeats), words."""
    rng = np.random.default_rng(seed)
    if kind == 0:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 1:
        return rng.integers(0, 4, n, dtype=np.uint8).tobytes()
    if kind == 2:
        return rng.standard_normal(n // 4 + 1).astype(np.float32) \
            .tobytes()[:n]
    if kind == 3:
        return (np.round(rng.standard_normal(n // 4 + 1) * 4) / 4) \
            .astype(np.float32).tobytes()[:n]
    words = [b"orbax ", b"ocdbt ", b"zarr", b"\n", b"chunk ", b"0.0 "]
    return b"".join(words[i] for i in rng.integers(0, 6, n // 2 + 1))[:n]


# -- 1. the zstd decoder -------------------------------------------------------


@settings(max_examples=60, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.integers(0, 4),
       size=st.one_of(st.integers(0, 600), st.integers(0, 1 << 20)),
       level=st.sampled_from([1, 3, 19]), checksum=st.booleans(),
       content_size=st.booleans(), seed=st.integers(0, 2 ** 31))
def test_zstd_equals_zstandard(kind, size, level, checksum, content_size,
                               seed):
    data = payload(kind, size, seed)
    frame = zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=content_size).compress(data)
    assert zdecode(frame, len(data)) == data
    if content_size:
        assert zdecode(frame) == data            # the size from the frame


@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_multi_block_frames_cover_the_block_kinds(level):
    """Frames of several blocks mixing compressed (Huffman, treeless,
    FSE, repeat modes), raw and RLE blocks decode as zstandard does."""
    parts = [payload(3, 300_000, level), payload(0, 200_000, level),
             bytes(150_000), payload(4, 300_000, level + 1),
             payload(2, 200_000, level + 2)]
    data = b"".join(parts)
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=True).compress(data)
    kinds = frame_blocks(frame)
    assert len(kinds) >= 8
    assert {k for k, _, _ in kinds} >= {0, 2}
    assert any(lt == 2 for _, lt, _ in kinds)
    assert any(m and 2 in m for _, _, m in kinds)
    assert zdecode(frame, len(data)) == data


def _raw_rle_frame(pieces, checksum_free=True):
    """A frame of raw (bytes) and RLE ((byte, count)) blocks, no
    checksum, content size stored."""
    total = sum(len(p) if isinstance(p, bytes) else p[1] for p in pieces)
    out = [bytes.fromhex("28b52ffd"), bytes([0xA0]),
           total.to_bytes(4, "little")]
    for i, p in enumerate(pieces):
        last = int(i == len(pieces) - 1)
        if isinstance(p, bytes):
            out += [((len(p) << 3) | last).to_bytes(3, "little"), p]
        else:
            out += [((p[1] << 3) | 2 | last).to_bytes(3, "little"),
                    bytes([p[0]])]
    return b"".join(out)


def test_zstd_raw_rle_skippable_and_concatenated_frames():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    pieces = [a, (7, 131_072), a[:5], (0, 1), b"", (255, 40_000)]
    frame = _raw_rle_frame(pieces)
    want = a + bytes([7]) * 131_072 + a[:5] + b"\0" + bytes([255]) * 40_000
    assert zstandard.ZstdDecompressor().decompress(frame) == want
    assert zdecode(frame) == want
    assert zdecode(W.zstd_raw_frame(want)) == want
    assert zdecode(W.zstd_raw_frame(b"")) == b""
    skip = (0x184D2A5A).to_bytes(4, "little") + (3).to_bytes(4, "little") \
        + b"xyz"
    other = zstandard.ZstdCompressor(level=3, write_checksum=True) \
        .compress(a)
    assert zdecode(skip + frame + other + skip, len(want) + len(a)) == \
        want + a


def test_zstd_corrupt_frames_return_an_error():
    rng = np.random.default_rng(11)
    frames = []
    for level in (1, 3, 19):
        for kind in (2, 3, 4):
            data = payload(kind, 50_000 if level == 19 else 200_000, level)
            frames.append((zstandard.ZstdCompressor(
                level=level, write_checksum=True).compress(data), data))
    flips = errors = 0
    for frame, data in frames:
        for cut in range(0, len(frame), max(1, len(frame) // 60)):
            with pytest.raises(ValueError, match="zstd"):
                zdecode(frame[:cut], len(data))
        for _ in range(150):
            bad = bytearray(frame)
            i = int(rng.integers(0, len(bad)))
            bad[i] ^= 1 << int(rng.integers(0, 8))
            flips += 1
            try:
                out = zdecode(bytes(bad), len(data))
            except ValueError:
                errors += 1
                continue
            assert out == data, f"flip at byte {i} decoded to other bytes"
        # garbage after a valid frame header
        for _ in range(40):
            junk = frame[:6] + rng.integers(
                0, 256, int(rng.integers(0, 3000)), dtype=np.uint8).tobytes()
            try:
                zdecode(junk, len(data))
            except ValueError:
                pass
    assert errors >= 0.98 * flips
    with pytest.raises(ValueError, match="expected"):
        zdecode(frames[0][0], len(frames[0][1]) + 1)


def test_zstd_refuses_dictionaries():
    d = zstandard.train_dictionary(
        2048, [payload(4, 300, s) for s in range(200)])
    frame = zstandard.ZstdCompressor(dict_data=d).compress(payload(4, 500, 1))
    with pytest.raises(ValueError, match="dictionary"):
        zdecode(frame, 500)


def test_crc32c_of_the_check_string():
    assert nativelib.crc32c(b"123456789") == 0xE3069283 == \
        W.crc32c(b"123456789")
    data = payload(0, 10_000, 3)
    assert nativelib.crc32c(data) == W.crc32c(data)


# -- 1b. the blosc decoder ------------------------------------------------------

BLOSC_CNAMES = ("blosclz", "lz4", "lz4hc", "snappy", "zlib", "zstd")


def _blosc_frames(cname, shuffle, itemsize, seed=0):
    """(frame, the bytes it holds) pairs tensorstore's blosc writes: a
    compressible array over 1 KiB blocks (the last one short), the same
    at the automatic block size, uniform bytes (streams stored raw), and
    a memcpyed frame (clevel 0)."""
    ts = pytest.importorskip("tensorstore")
    rng = np.random.default_rng(seed)
    dt = {1: "|u1", 2: "<i2", 4: "<f4", 8: "<f8"}[itemsize]
    n = 600_007 // itemsize
    smooth = np.round(rng.standard_normal(n) * 8) / 8
    arrays = [(smooth.astype(dt) if itemsize > 1 else
               rng.integers(0, 6, n).astype(np.uint8), 5, 65536),
              (smooth[:n // 2].astype(dt) if itemsize > 1 else
               rng.integers(0, 3, n // 2).astype(np.uint8), 9, 0),
              (np.frombuffer(rng.bytes(n * itemsize), dt), 5, 2048),
              (np.frombuffer(rng.bytes(n * itemsize), dt), 0, 0)]
    out = []
    for a, clevel, blocksize in arrays:
        t = ts.open({"driver": "zarr", "kvstore": {"driver": "memory"},
                     "metadata": {"shape": [a.size], "chunks": [a.size],
                                  "dtype": dt, "compressor": {
                                      "id": "blosc", "cname": cname,
                                      "clevel": clevel, "shuffle": shuffle,
                                      "blocksize": blocksize}}},
                    create=True).result()
        t.write(a).result()
        out.append((bytes(t.kvstore.read(b"0").result().value),
                    a.tobytes()))
    return out


@pytest.mark.parametrize("itemsize", [1, 2, 4, 8])
@pytest.mark.parametrize("shuffle", [0, 1, 2])
@pytest.mark.parametrize("cname", BLOSC_CNAMES)
def test_blosc_equals_tensorstore(cname, shuffle, itemsize):
    """``native/nns_blosc.cc`` decodes every frame tensorstore's blosc
    writes: each cname, no shuffle, byte shuffle and bitshuffle, element
    sizes 1 to 8, frames over many blocks (split into a stream a byte of
    the element where blosc splits), raw streams and memcpyed frames."""
    frames = _blosc_frames(cname, shuffle, itemsize,
                           seed=BLOSC_CNAMES.index(cname) * 100 + shuffle)
    flags = [f[2] for f, _ in frames]
    assert flags[3] & 0x02                  # clevel 0: memcpyed
    assert (flags[0] >> 5) == {"blosclz": 0, "lz4": 1, "lz4hc": 1,
                               "snappy": 2, "zlib": 3, "zstd": 4}[cname]
    blocksize = int.from_bytes(frames[0][0][8:12], "little")
    assert blocksize < len(frames[0][1]) and len(frames[0][1]) % blocksize
    for frame, data in frames:
        assert nativelib.blosc_decompress(frame, len(data)).tobytes() == \
            data
        assert nativelib.blosc_decompress(frame).tobytes() == data


def test_blosc_corrupt_frames_raise():
    """A truncated frame, or a header or block table out of its bounds,
    raises ``ValueError``; a flipped bit elsewhere raises or decodes to
    the frame's declared size (blosc frames carry no checksum), never
    past its buffers."""
    rng = np.random.default_rng(12)
    flips = errors = 0
    for cname in BLOSC_CNAMES:
        frame, data = _blosc_frames(cname, 1, 4, seed=7)[0]
        for cut in range(0, len(frame), max(1, len(frame) // 50)):
            with pytest.raises(ValueError, match="blosc"):
                nativelib.blosc_decompress(frame[:cut])
        bad = bytearray(frame)
        bad[0] = 3                                   # a blosc2 version
        with pytest.raises(ValueError, match="unsupported"):
            nativelib.blosc_decompress(bytes(bad))
        for at, value in ((4, len(data) + 1), (8, 0), (12, len(frame) + 1),
                          (16, len(frame)), (16, 3)):
            bad = bytearray(frame)
            bad[at:at + 4] = value.to_bytes(4, "little")
            with pytest.raises(ValueError, match="blosc"):
                nativelib.blosc_decompress(bytes(bad), len(data))
        for _ in range(100):
            bad = bytearray(frame)
            i = int(rng.integers(16, len(bad)))
            bad[i] ^= 1 << int(rng.integers(0, 8))
            flips += 1
            try:
                out = nativelib.blosc_decompress(bytes(bad))
            except ValueError:
                errors += 1
                continue
            assert len(out) == len(data)
    assert errors > 0.2 * flips
    with pytest.raises(ValueError, match="expected"):
        nativelib.blosc_decompress(frame, len(data) + 4)


# -- 2. the OCDBT store --------------------------------------------------------


def test_ocdbt_against_tensorstore(tmp_path):
    """Small nodes force interior levels, subtree prefixes, inline and
    indirect values over many data files and versions."""
    ts = pytest.importorskip("tensorstore")
    root = tmp_path / "kv"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"max_decoded_node_bytes": 200,
                                     "max_inline_value_bytes": 8}}).result()
    for i in range(40):
        kv.write(f"key/{i:03d}/abc", bytes([i]) * (i % 20)).result()
    with ts.Transaction() as txn:
        for i in range(40, 120):
            kv.with_transaction(txn).write(f"key/{i:03d}/xyz",
                                           bytes([i]) * 5)
    kv.delete_range(ts.KvStore.KeyRange("key/010", "key/013")).result()
    db = Ocdbt(str(root))
    keys = [k.decode() for k in kv.list().result()]
    assert db.list() == sorted(keys) and len(keys) == 117
    for k in keys:
        assert db.read(k) == kv.read(k).result().value
    assert db.read("key/011/abc") is None
    assert db.generation > 16          # older versions sit in version nodes


@pytest.mark.parametrize("compression", [None, "zstd"])
def test_ocdbt_numbered_manifests_against_tensorstore(tmp_path, compression):
    """``manifest_kind: numbered``: ``manifest.ocdbt`` holds the config
    alone and each commit a ``manifest.<16 hex digits>``; the newest one
    is read, equal to tensorstore's own reads after many commits."""
    ts = pytest.importorskip("tensorstore")
    root = tmp_path / "kv"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"manifest_kind": "numbered",
                                     "max_decoded_node_bytes": 300,
                                     "compression": {"id": compression}
                                     if compression else None}}).result()
    for i in range(30):
        kv.write(f"key/{i % 12:03d}", bytes([i]) * (i * 7 % 150)).result()
    kv.delete_range(ts.KvStore.KeyRange("key/003", "key/005")).result()
    names = sorted(os.listdir(root))
    numbered = [n for n in names if n.startswith("manifest.0")]
    assert "manifest.ocdbt" in names and len(numbered) >= 30
    db = Ocdbt(str(root))
    keys = [k.decode() for k in kv.list().result()]
    assert db.list() == sorted(keys) and len(keys) == 10
    for k in keys:
        assert db.read(k) == kv.read(k).result().value
    assert db.generation == int(numbered[-1][len("manifest."):], 16)
    db.close()
    # another store's numbered manifest under this config is refused
    other = tmp_path / "other"
    kv2 = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{other}/",
                           "config": {"manifest_kind": "numbered"}}).result()
    kv2.write("a", b"b").result()
    shutil.copy(other / "manifest.0000000000000001",
                root / "manifest.ffffffffffffffff")
    with pytest.raises(OcdbtError, match="not a version manifest"):
        Ocdbt(str(root))
    os.remove(root / "manifest.ffffffffffffffff")
    raw = bytearray((root / numbered[-1]).read_bytes())
    raw[len(raw) // 2] ^= 4
    (root / numbered[-1]).write_bytes(bytes(raw))
    with pytest.raises(OcdbtError, match="CRC-32C"):
        Ocdbt(str(root))


def test_ocdbt_numbered_store_with_no_commit_is_empty(tmp_path):
    ts = pytest.importorskip("tensorstore")
    root = tmp_path / "kv"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"manifest_kind": "numbered"}}).result()
    kv.write("a", b"x").result()
    for n in os.listdir(root):
        if n.startswith("manifest.0"):
            os.remove(root / n)
    db = Ocdbt(str(root))
    assert db.list() == [] and db.generation == 0


def _root_node_file(step: str) -> str:
    files = [f for f in os.listdir(os.path.join(step, "d"))]
    assert len(files) == 1
    return os.path.join(step, "d", files[0])


def test_ocdbt_damage_raises(tmp_path):
    step = str(tmp_path / "step")
    shutil.copytree(W.FIXTURE_DIR, step)
    Ocdbt(step)
    rng = np.random.default_rng(2)
    for path in (os.path.join(step, "manifest.ocdbt"),
                 _root_node_file(step)):
        good = open(path, "rb").read()
        for cut in range(0, len(good), 7):
            open(path, "wb").write(good[:cut])
            with pytest.raises(OcdbtError):
                Ocdbt(step)
        for _ in range(60):
            bad = bytearray(good)
            bad[int(rng.integers(0, len(bad)))] ^= \
                1 << int(rng.integers(0, 8))
            open(path, "wb").write(bytes(bad))
            with pytest.raises(OcdbtError):
                Ocdbt(step)
        open(path, "wb").write(good)
    Ocdbt(step)


# -- 3. steps the JAX package writes -------------------------------------------


def _dtypes_tree(rng):
    return {
        "f32": rng.standard_normal((5, 7)).astype(np.float32),
        "f16": rng.standard_normal(9).astype(np.float16),
        "f64": rng.standard_normal((2, 3)),
        "bf16": jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16),
        "ints": [rng.integers(-128, 127, 6).astype(np.int8),
                 rng.integers(-2 ** 31, 2 ** 31 - 1, (3, 2)).astype(np.int32),
                 rng.integers(-2 ** 62, 2 ** 62, 4).astype(np.int64),
                 rng.integers(0, 255, (2, 2, 2)).astype(np.uint8),
                 rng.integers(0, 2, 5).astype(np.bool_)],
        "scalars": {"f": np.float32(2.5), "i": np.int64(-7),
                    "py_float": 0.125, "py_int": 42,
                    "jax": jnp.float32(3.25)},
        "nested": {"a": {"b": [{"c": np.arange(4, dtype=np.int16)},
                               np.ones((1, 1), np.float32)]}},
        "empty": {"d": {}, "l": [], "n": None},
        "0": np.arange(3, dtype=np.uint16),   # a digit dict key
    }


def test_dtypes_and_structure_bit_equal_to_orbax(tmp_path):
    path = tmp_path / "ck"
    save_orbax(str(path), _dtypes_tree(np.random.default_rng(0)))
    assert_same(tck.load_dir(str(path)), restore(path))


def test_sharded_and_replicated_leaves_in_several_chunks(tmp_path):
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                ("data", "model"))
    rng = np.random.default_rng(1)
    tree = {
        "w": jax.device_put(rng.standard_normal((64, 32)).astype(np.float32),
                            NamedSharding(mesh, P("data", "model"))),
        "rep": jax.device_put(np.arange(16, dtype=np.float32),
                              NamedSharding(mesh, P())),
        "rep2": jax.device_put(
            rng.standard_normal((24, 5)).astype(np.float32),
            NamedSharding(mesh, P())),
        "rows": jax.device_put(rng.integers(0, 9, (8, 3)).astype(np.int32),
                               NamedSharding(mesh, P("data"))),
        "bf": jax.device_put(jnp.asarray(rng.standard_normal((8, 4)),
                                         jnp.bfloat16),
                             NamedSharding(mesh, P(None, "model"))),
    }
    path = tmp_path / "ck"
    save_orbax(str(path), tree)
    chunks = {}
    for key in Ocdbt(str(path)).list():
        name, _, chunk = key.partition("/")
        if chunk != ".zarray":
            chunks[name] = chunks.get(name, 0) + 1
    assert chunks["w"] == 8 and chunks["rep"] == 8 and chunks["rep2"] > 1
    assert chunks["rows"] > 1 and chunks["bf"] > 1
    assert_same(tck.load_dir(str(path)), restore(path))


def test_use_ocdbt_false_save(tmp_path):
    path = tmp_path / "ck"
    tree = {"x": np.arange(6, dtype=np.float32),
            "y": {"z": np.ones((2, 2), np.int8)},
            "s": np.float64(0.5)}
    ckptr = ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False))
    ckptr.save(str(path), args=ocp.args.StandardSave(tree))
    assert not os.path.exists(path / "manifest.ocdbt")
    assert os.path.isfile(path / "y.z" / ".zarray")
    assert_same(tck.load_dir(str(path)), ckptr.restore(str(path)))


def jck_apply(params, x, train=False):
    return x @ params["w"] + params["b"]


def test_jax_tensor_trainer_step(tmp_path):
    """The step ``tests/test_checkpoint.py``'s JAX trainer writes
    (``mesh: data:-1``, 8 devices): several chunks a leaf, bit-equal."""
    from nnstreamer_tpu.core import Buffer, TensorsSpec
    from nnstreamer_tpu.elements.basic import AppSink, AppSrc
    from nnstreamer_tpu.runtime import Pipeline
    from nnstreamer_tpu.runtime.registry import make

    ck = str(tmp_path / "trainer_ck")
    p = Pipeline()
    src = AppSrc(name="src", spec=TensorsSpec.parse("4:1,1:1",
                                                    "float32,int32"))
    trn = make("tensor_trainer", el_name="trn", framework="jax-optax",
               model_config={"apply": "test_torch_orbax:jck_apply",
                             "init": {"w": np.zeros((4, 2), np.float32),
                                      "b": np.zeros((16,), np.float32)[:2]},
                             "batch_size": 8, "lr": 0.5, "mesh": "data:-1"},
               model_save_path=ck, num_inputs=1, num_labels=1,
               num_training_samples=16, epochs=1)
    snk = AppSink(name="out", max_buffers=64)
    p.add(src, trn, snk).link(src, trn, snk)
    rng = np.random.default_rng(0)
    with p:
        for _ in range(16):
            x = rng.standard_normal((1, 4)).astype(np.float32)
            src.push_buffer(Buffer.of(x, np.array([[int(x.sum() > 0)]],
                                                  np.int32)))
        src.end_of_stream()
        assert p.wait_eos(timeout=180)
    got = tck.load_dir(ck)
    assert np.abs(got["w"]).sum() > 0
    assert_same(got, restore(ck))


_BASE = {"w": np.zeros((2, 3), np.float32), "b": np.zeros(3, np.float32),
         "i": np.int64(0), "l": [np.zeros(2, np.uint8)]}


@pytest.mark.parametrize("case, template", [
    ("same", _BASE),
    ("cast", {**_BASE, "w": np.zeros((2, 3), np.float16),
              "b": np.zeros(3, jnp.bfloat16), "i": np.int32(0)}),
    ("cast_to_int", {**_BASE, "w": np.zeros((2, 3), np.int32)}),
    ("bf16_to_f32", {**_BASE, "l": [np.zeros(2, np.float32)]}),
    ("shape_mismatch", {**_BASE, "w": np.zeros((3, 3), np.float32)}),
    ("rank_mismatch", {**_BASE, "w": np.zeros(6, np.float32)}),
    ("extra_key", {**_BASE, "z": np.zeros(3, np.float32)}),
    ("missing_key", {k: v for k, v in _BASE.items() if k != "b"}),
    ("list_length", {**_BASE, "l": [np.zeros(2, np.uint8)] * 2}),
    ("list_as_dict", {**_BASE, "l": {"0": np.zeros(2, np.uint8)}}),
    ("none_leaf", {**_BASE, "i": None}),
])
def test_template_as_orbax(tmp_path, case, template):
    path = tmp_path / "ck"
    save_orbax(str(path), {
        "w": np.arange(6, dtype=np.float32).reshape(2, 3) + 0.3,
        "b": np.array([1e-3, -2.5, 7e4], np.float32), "i": np.int64(7),
        "l": [np.array([3, 250], np.uint8) if case != "bf16_to_f32"
              else jnp.asarray([1.5, -2.25], jnp.bfloat16)]})
    try:
        want = restore(path, template)
    except ValueError:
        with pytest.raises(OrbaxFormatError, match="structure"):
            tck.load_dir(str(path), template)
        assert case in ("extra_key", "missing_key", "list_length",
                        "list_as_dict")
        return
    assert case not in ("extra_key", "missing_key", "list_length",
                        "list_as_dict")
    assert_same(tck.load_dir(str(path), template), want)
    # a torch template (bf16 included) gives the same leaves
    ttemplate = {k: (torch.zeros(v.shape, dtype=torch.bfloat16)
                     if getattr(v, "dtype", None) is not None
                     and str(v.dtype) == "bfloat16"
                     else torch.from_numpy(np.asarray(v))
                     if isinstance(v, np.ndarray) else v)
                 for k, v in template.items()}
    assert_same(tck.load_dir(str(path), ttemplate), want)


# -- 4. the tests' writer ------------------------------------------------------


def test_writer_steps_restore_in_orbax(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((300, 200)).astype(np.float32),
            "grid": rng.standard_normal((10, 7)).astype(np.float32),
            "bf": torch.randn(4, 6, generator=torch.Generator().manual_seed(
                0)).to(torch.bfloat16),
            "s": 2.5, "i": 7,
            "l": [np.arange(3, dtype=np.int8), np.float32(1.5)],
            "big": rng.standard_normal(100_000).astype(np.float32)}
    path = str(tmp_path / "ck")
    # a chunk grid that does not divide the shape: edge chunks are cut
    W.write_orbax_step(path, tree, chunks={"grid": (3, 4), "big": (30_000,)})
    want = restore(path)
    assert_same(tck.load_dir(path), want)
    np.testing.assert_array_equal(np.asarray(want["grid"]), tree["grid"])
    # orbax stored every chunk: a missing one is damage, for both readers
    W.write_orbax_step(path, tree, chunks={"grid": (3, 4)},
                       missing=["grid/1.1"])
    with pytest.raises(ValueError, match="grid/1.1"):
        restore(path)
    with pytest.raises(OrbaxFormatError, match="grid/1.1"):
        tck.load_dir(path)
    # where the step says it did not, the missing chunk reads as fill
    meta_path = os.path.join(path, "_METADATA")
    meta = json.load(open(meta_path))
    meta["store_array_data_equal_to_fill_value"] = False
    json.dump(meta, open(meta_path, "w"))
    want = restore(path)
    assert_same(tck.load_dir(path), want)
    assert not np.asarray(want["grid"])[3:6, 4:7].any()


# -- 5. the committed fixture --------------------------------------------------


def test_fixture_frames_and_tree():
    db = Ocdbt(W.FIXTURE_DIR)
    kinds = {k: frame_blocks(db.read(k)) for k in db.list()
             if not k.endswith(".zarray")}
    multi = [k for k, b in kinds.items() if len(b) > 1
             and any(lt == 2 for _, lt, _ in b)
             and any(m and 2 in m for _, _, m in b)]
    assert multi == ["quant/0.0"], kinds
    assert os.path.isdir(os.path.join(W.FIXTURE_DIR, "ocdbt.process_0"))
    assert W.step_bytes(W.FIXTURE_DIR) <= 256 * 1024
    want = W.fixture_tree()
    got = tck.load_dir(W.FIXTURE_DIR)
    assert_same(got, want)
    assert_same(got, restore(W.FIXTURE_DIR))


# -- 6. the other forms orbax's restore reads, and refusals ----------------------


def _files_step(tmp_path):
    path = tmp_path / "files"
    ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)).save(
        str(path), args=ocp.args.StandardSave(
            {"x": np.arange(6, dtype=np.float32)}))
    return path


@pytest.mark.parametrize("field, value, match", [
    ("compressor", "zstd", "compressor 'zstd'"),
    ("compressor", {"id": "lz4"}, "compressor 'lz4'"),
    ("shape", "six", "malformed .zarray"),
    ("filters", [{"id": "delta", "dtype": "<f4"}], "filters"),
    ("order", "K", "order 'K'"),
    ("dtype", "<U4", "dtype"),
    ("dtype", "|O", "dtype"),
    ("dtype", ">f16", "dtype"),
    ("dimension_separator", "-", "dimension_separator"),
    ("fill_value", "Nope", "fill_value"),
])
def test_zarray_refusals_name_the_field(tmp_path, field, value, match):
    """What stays refused in a ``.zarray``: a compressor tensorstore does
    not write, ``filters`` (tensorstore refuses to write them), malformed
    metadata, dtypes outside the set read, each naming its field.  The
    forms this test refused before (blosc, order F, ``<c8``) are read:
    ``test_zarr2_forms_read_as_orbax_reads_them``."""
    path = _files_step(tmp_path)
    zarray = path / "x" / ".zarray"
    meta = json.loads(zarray.read_text())
    meta[field] = value
    zarray.write_text(json.dumps(meta))
    with pytest.raises(OrbaxFormatError, match=match):
        tck.load_dir(str(path))


def test_zarr3_and_neither_format_refused(tmp_path):
    """A ``use_zarr3`` step (orbax's own, per-file arrays) reads as
    orbax's restore reads it; ``_METADATA`` claiming zarr v3 over zarr v2
    arrays raises naming the missing ``zarr.json``; a directory of
    neither format is refused."""
    tree = {"x": np.arange(6, dtype=np.float32), "y": {"z": np.int8(3)}}
    z3 = str(tmp_path / "z3")
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(
        use_zarr3=True, use_ocdbt=False)).save(
        z3, args=ocp.args.PyTreeSave(tree))
    assert os.path.isfile(os.path.join(z3, "x", "zarr.json"))
    assert_same(tck.load_dir(z3), restore(z3))
    path = _files_step(tmp_path)
    meta = json.loads((path / "_METADATA").read_text())
    meta["use_zarr3"] = True
    (path / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(OrbaxFormatError, match="zarr.json"):
        tck.load_dir(str(path))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="params.safetensors.*_METADATA"):
        tck.load_dir(str(empty))


def _v2_meta(compressor=None, order="C", endian=None, chunks=2):
    """A zarr v2 leaf metadata for :func:`W.ts_step`: ``chunks`` parts a
    dimension, ``endian`` ``>`` for big-endian dtypes."""
    def meta(name, a):
        dt = "bfloat16" if a.dtype.name == "bfloat16" else \
            a.dtype.newbyteorder(endian).str if endian else a.dtype.str
        return {"shape": list(a.shape), "chunks": W._part(a.shape, chunks),
                "dtype": dt, "compressor": compressor,
                "order": order if a.ndim > 1 else "C", "fill_value": None}
    return meta


def _forms_tree(rng):
    """Every dtype the readers read, 0-d to 3-d, for the form tests."""
    return {
        "f32": rng.standard_normal((9, 14)).astype(np.float32),
        "f16": (np.round(rng.standard_normal((6, 5, 4)) * 4) / 4)
        .astype(np.float16),
        "f64": rng.standard_normal(7),
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((5, 6)),
                                       jnp.bfloat16)),
        "c64": (rng.standard_normal((3, 4)) + 1j).astype(np.complex64),
        "c128": rng.standard_normal(3) * (1 - 2j),
        "ints": {"i8": rng.integers(-128, 127, 10).astype(np.int8),
                 "i16": rng.integers(-999, 999, (4, 3)).astype(np.int16),
                 "u32": rng.integers(0, 2 ** 32 - 1, 5).astype(np.uint32),
                 "i64": rng.integers(-2 ** 62, 2 ** 62, (2, 3))
                 .astype(np.int64),
                 "u8": rng.integers(0, 255, (3, 3, 3)).astype(np.uint8),
                 "b": rng.integers(0, 2, 6).astype(np.bool_)},
        "zero_d": np.array(-2.75, np.float32),
    }


_V2_CASES = {
    **{c: _v2_meta({"id": c, "level": 5}) for c in ("zlib", "gzip", "bz2")},
    **{f"blosc_{c}_{sh}": _v2_meta({"id": "blosc", "cname": c, "clevel": 5,
                                   "shuffle": sh, "blocksize": 256})
       for c in ("blosclz", "lz4", "lz4hc", "snappy", "zlib", "zstd")
       for sh in (0, 1, 2)},
    "order_F": _v2_meta({"id": "zstd", "level": 1}, "F", chunks=1),
    "order_F_chunks": _v2_meta(None, "F", chunks=3),
    "big_endian": _v2_meta({"id": "zstd", "level": 1}, endian=">"),
    "big_endian_F_gzip": _v2_meta({"id": "gzip", "level": 1}, "F", ">"),
}


@pytest.mark.parametrize("case", sorted(_V2_CASES))
def test_zarr2_forms_read_as_orbax_reads_them(tmp_path, case):
    """Zarr v2 arrays tensorstore writes with each compressor (blosc with
    every cname and shuffle over 256-byte blocks), order F, big-endian
    dtypes (back native-endian) and complex dtypes: each leaf bit-equal to
    orbax's restore, and to the tree."""
    tree = _forms_tree(np.random.default_rng(21))
    path = W.ts_step(str(tmp_path / "ck"), tree, False, _V2_CASES[case])
    want = restore(path)
    assert_same(tck.load_dir(path), want)
    assert_same(_as_port(want), tree)


def _v3_meta(codecs=None, chunks=2, key=None, fill=None, grid=None):
    """A zarr v3 leaf metadata for :func:`W.ts_step`: ``codecs(a)`` its
    codec chain, ``chunks`` parts a dimension (or ``grid(a)`` the chunk
    shape), ``key`` its chunk key encoding, ``fill(a)`` its fill value."""
    def meta(name, a):
        dt = "bfloat16" if a.dtype.name == "bfloat16" else W._v3_type(a)
        out = {"shape": list(a.shape), "data_type": dt,
               "chunk_grid": {"name": "regular", "configuration": {
                   "chunk_shape": grid(a) if grid else
                   W._part(a.shape, chunks)}},
               "fill_value": fill(a) if fill else
               [0, 0] if a.dtype.kind == "c" else
               False if a.dtype.kind == "b" else 0}
        if codecs is not None:
            out["codecs"] = codecs(a)
        if key is not None:
            out["chunk_key_encoding"] = key
        return out
    return meta


_LE = {"name": "bytes", "configuration": {"endian": "little"}}
_BE = {"name": "bytes", "configuration": {"endian": "big"}}


def _sharded(k, codecs, at="end", crc=True, levels=1):
    """Shards of ``k`` inner chunks a dimension (``levels`` of sharding
    nested), the inner chain ``codecs`` (tensorstore refuses bytes codecs
    after a sharding codec)."""
    def inner(a):
        return W._part(a.shape, 2 * k ** levels)

    def chain(shape, level):
        if level == 0:
            return list(codecs)
        return [{"name": "sharding_indexed", "configuration": {
            "chunk_shape": [c * k ** (level - 1) for c in shape],
            "codecs": chain(shape, level - 1),
            "index_codecs": [_LE] + [{"name": "crc32c"}] * crc,
            "index_location": at}}]

    return _v3_meta(lambda a: chain(inner(a), levels),
                    grid=lambda a: [c * k ** levels for c in inner(a)])


def _hex_fill(a):
    """Each dtype's fill value as the hex string of its bits (NaN for the
    floats), a number for the integers."""
    hexes = {"float16": "0x7e00", "bfloat16": "0x7fc0",
             "float32": "0x7fc00000", "float64": "0x7ff8000000000000"}
    if a.dtype.kind == "c":
        part = "0x7fc00000" if a.dtype.itemsize == 8 else \
            "0x7ff8000000000000"
        return [part, 0.5]
    if a.dtype.kind == "b":
        return True
    return hexes.get(a.dtype.name, 1)


_V3_CASES = {
    "bytes_little": _v3_meta(lambda a: [_LE]),
    "bytes_big": _v3_meta(lambda a: [_BE]),
    "transpose": _v3_meta(lambda a: [{"name": "transpose", "configuration": {
        "order": list(range(a.ndim))[::-1]}}, _LE], chunks=3),
    "transpose_twice": _v3_meta(lambda a: [
        {"name": "transpose", "configuration": {
            "order": list(range(1, a.ndim)) + [0] if a.ndim else []}},
        {"name": "transpose", "configuration": {
            "order": list(range(a.ndim))[::-1]}}, _BE]),
    "zstd": _v3_meta(lambda a: [_LE, {"name": "zstd", "configuration": {
        "level": 5, "checksum": True}}]),
    "gzip": _v3_meta(lambda a: [_BE, {"name": "gzip",
                                      "configuration": {"level": 6}}]),
    "blosc": _v3_meta(lambda a: [_LE, {"name": "blosc", "configuration": {
        "cname": "lz4", "clevel": 5, "shuffle": "bitshuffle",
        "typesize": a.dtype.itemsize, "blocksize": 0}}]),
    "blosc_snappy_shuffle": _v3_meta(lambda a: [_LE, {
        "name": "blosc", "configuration": {
            "cname": "snappy", "clevel": 5, "shuffle": "shuffle",
            "typesize": a.dtype.itemsize, "blocksize": 0}}]),
    "crc32c": _v3_meta(lambda a: [_LE, {"name": "crc32c"}]),
    "gzip_crc32c_zstd": _v3_meta(lambda a: [
        _LE, {"name": "gzip", "configuration": {"level": 1}},
        {"name": "crc32c"}, {"name": "zstd", "configuration": {
            "level": 1}}]),
    "sharding_end": _sharded(1, [_LE]),
    "sharding_inner_start": _sharded(
        2, [_LE, {"name": "zstd", "configuration": {"level": 1}}],
        at="start"),
    "sharding_no_crc": _sharded(2, [_BE], crc=False),
    "sharding_nested": _sharded(2, [_LE, {"name": "crc32c"}], levels=2),
    "sharding_inner_gzip_crc32c": _sharded(2, [
        _BE, {"name": "gzip", "configuration": {"level": 1}},
        {"name": "crc32c"}]),
    "key_default_slash": _v3_meta(lambda a: [_LE], chunks=3, key={
        "name": "default", "configuration": {"separator": "/"}}),
    "key_default_dot": _v3_meta(lambda a: [_LE], chunks=3, key={
        "name": "default", "configuration": {"separator": "."}}),
    "key_v2_dot": _v3_meta(lambda a: [_LE], chunks=3, key={
        "name": "v2", "configuration": {"separator": "."}}),
    "key_v2_slash": _v3_meta(lambda a: [_LE], chunks=3, key={
        "name": "v2", "configuration": {"separator": "/"}}),
    "fill_special": _v3_meta(lambda a: [_LE], fill=lambda a: W._v3_fill(
        a, special=True)),
    "fill_hex": _v3_meta(lambda a: [_LE], fill=_hex_fill),
}


@pytest.mark.parametrize("with_template", [False, True])
@pytest.mark.parametrize("case", sorted(_V3_CASES))
def test_zarr3_codecs_read_as_orbax_reads_them(tmp_path, case,
                                               with_template):
    """Zarr v3 arrays tensorstore writes with each codec chain and chunk
    key encoding (under orbax's ``use_zarr3`` ``_METADATA``): each leaf
    bit-equal to orbax's restore, with and without a template (the tree's
    own dtypes, one leaf cast to float64)."""
    tree = _forms_tree(np.random.default_rng(22))
    path = W.ts_step(str(tmp_path / "ck"), tree, True, _V3_CASES[case])
    template = None
    if with_template:
        template = {k: v for k, v in tree.items()}
        template["f32"] = np.zeros(tree["f32"].shape, np.float64)
    want = restore(path, template)
    assert_same(tck.load_dir(path, template), want)
    if not with_template:
        assert_same(_as_port(want), tree)


def test_zarr3_per_file_step(tmp_path):
    """``use_ocdbt: false`` with zarr v3 arrays: ``<name>/zarr.json`` and
    the chunk files under the step directory."""
    tree = _forms_tree(np.random.default_rng(23))
    path = W.ts_step(str(tmp_path / "ck"), tree, True,
                     _V3_CASES["sharding_inner_start"], use_ocdbt=False)
    assert os.path.isfile(os.path.join(path, "f32", "zarr.json"))
    assert_same(tck.load_dir(path), restore(path))


@pytest.mark.parametrize("case", ["sharding_end", "sharding_inner_start",
                                  "sharding_nested", "bytes_little"])
def test_zarr3_missing_chunks_hold_the_fill_value(tmp_path, case):
    """Where chunks equal to the fill value were not stored (whole leaves
    and blocks of zeros), the shard index marks those inner chunks
    missing, or the chunk is absent: read as the fill value, as orbax's
    restore reads them, once ``_METADATA`` says not every chunk was
    stored."""
    tree = _forms_tree(np.random.default_rng(24))
    tree["f32"][:5] = 0
    tree["f16"][:, :3] = 0
    tree["ints"]["i16"] = np.zeros_like(tree["ints"]["i16"])
    path = W.ts_step(str(tmp_path / "ck"), tree, True, _V3_CASES[case],
                     store_fill=False)
    db = Ocdbt(path)
    keys = db.list()
    db.close()
    assert not any(k.startswith("ints.i16/c") for k in keys)
    want = restore(path)
    assert_same(tck.load_dir(path), want)
    assert_same(_as_port(want), tree)


def _z3_step(tmp_path):
    path = tmp_path / "z3"
    ocp.Checkpointer(ocp.PyTreeCheckpointHandler(
        use_zarr3=True, use_ocdbt=False)).save(
        str(path), args=ocp.args.PyTreeSave(
            {"x": np.arange(12, dtype=np.float32).reshape(3, 4)}))
    return path


def _edit(meta, path, value):
    node = meta
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value


@pytest.mark.parametrize("where, value, match", [
    (("codecs", 0, "configuration", "codecs", 1),
     {"name": "lz4", "configuration": {}}, "codec 'lz4'"),
    (("codecs",), [{"name": "vlen-utf8"}], "codec 'vlen-utf8'"),
    (("codecs", 0, "configuration", "index_codecs", 1),
     {"name": "zstd"}, "index_codecs"),
    (("codecs", 0, "configuration", "index_location"), "middle",
     "index_location"),
    (("codecs", 0, "configuration", "chunk_shape"), [2, 4],
     "does not divide"),
    (("chunk_grid",), {"name": "rectilinear", "configuration": {
        "chunk_shapes": [[1, 2], [4]]}}, "chunk_grid 'rectilinear'"),
    (("chunk_key_encoding",), {"name": "hashed"}, "chunk_key_encoding"),
    (("storage_transformers",), [{"name": "sharding"}],
     "storage_transformers"),
    (("data_type",), "string", "data_type"),
    (("zarr_format",), 2, "zarr_format"),
    (("node_type",), "group", "node_type"),
    (("shape",), "twelve", "malformed zarr.json"),
])
def test_zarr3_refusals_name_the_field(tmp_path, where, value, match):
    """What a zarr v3 array may hold that the reader refuses, naming the
    field: another codec, a non-regular grid, another chunk key
    encoding, storage transformers, an unread data type."""
    path = _z3_step(tmp_path)
    zjson = path / "x" / "zarr.json"
    meta = json.loads(zjson.read_text())
    _edit(meta, where, value)
    zjson.write_text(json.dumps(meta))
    with pytest.raises(OrbaxFormatError, match=match):
        tck.load_dir(str(path))


@pytest.mark.parametrize("damage, match", [
    ("shard_index", r"x/c/0/0 \(shard index\): crc32c mismatch"),
    ("inner_chunk", r"x/c/0/0 inner chunk \[0, 0\]: zstd"),
    ("truncated", "x/c/0/0: shard of 10 bytes"),
])
def test_zarr3_damaged_shards_raise(tmp_path, damage, match):
    """A flipped bit in a shard's index fails its CRC-32C; a damaged
    inner chunk fails its decoder; a cut shard raises; each naming the
    chunk key."""
    path = _z3_step(tmp_path)
    chunk = path / "x" / "c" / "0" / "0"
    raw = bytearray(chunk.read_bytes())
    if damage == "shard_index":
        raw[-8] ^= 1
    elif damage == "inner_chunk":
        raw[2] ^= 0xFF
    else:
        raw = raw[:10]
    chunk.write_bytes(bytes(raw))
    with pytest.raises(OrbaxFormatError, match=match):
        tck.load_dir(str(path))


# -- 7. the port's writer --------------------------------------------------------


def _port_tree(rng):
    """``_dtypes_tree`` as the port holds it: bf16 as a torch tensor, no
    JAX arrays; and the same tree with those leaves as JAX arrays."""
    tree = _dtypes_tree(rng)
    bf = np.array(tree["bf16"])
    tree["bf16"] = torch.from_numpy(bf.view(np.int16)).view(torch.bfloat16)
    tree["scalars"]["jax"] = np.float32(3.25)
    jtree = dict(tree, bf16=jnp.asarray(bf),
                 scalars=dict(tree["scalars"], jax=jnp.float32(3.25)))
    return tree, jtree


def _as_port(tree):
    """An orbax restore with each numpy bf16 leaf as the port's torch
    bf16 tensor of the same bits (``assert_same``'s form of ``got``)."""
    if isinstance(tree, dict):
        return {k: _as_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_port(v) for v in tree]
    if getattr(tree, "dtype", None) is not None and \
            str(tree.dtype) == "bfloat16":
        return torch.from_numpy(np.asarray(tree).view(np.int16)).view(
            torch.bfloat16)
    return tree


def _template(tree):
    return {k: _template(v) if isinstance(v, dict) else
            [_template(x) if isinstance(x, dict) else x for x in v]
            if isinstance(v, list) else
            jnp.zeros(v.shape, jnp.bfloat16) if isinstance(v, torch.Tensor)
            else v for k, v in tree.items()}


@pytest.mark.parametrize("with_template", [False, True])
def test_port_steps_read_by_orbax_bit_for_bit(tmp_path, with_template):
    """The port's step and the JAX package's step of one tree: orbax's
    restore gives the same leaves from both, bit for bit, in the same
    structure and types; the port's reader reads the port's step as
    orbax does."""
    tree, jtree = _port_tree(np.random.default_rng(0))
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    assert tck.save_dir(port, tree) == port
    save_orbax(ref, jtree)
    template = _template(tree) if with_template else None
    want = restore(ref, template)
    assert_same(_as_port(restore(port, template)), want)
    assert_same(tck.load_dir(port, template), want)
    assert_same(load_orbax(port), restore(ref))

    def value_types(path):
        meta = json.load(open(os.path.join(path, "_METADATA")))
        return {k: v["value_metadata"]["value_type"]
                for k, v in meta["tree_metadata"].items()}

    # the port writes its arrays as numpy arrays, where JAX's are jax.Array
    assert value_types(port) == {
        k: "np.ndarray" if t == "jax.Array" else t
        for k, t in value_types(ref).items()}


def test_port_step_of_a_trained_mobilenet(tmp_path):
    """A tree the port trains (``trained_tree`` after two steps) through
    ``save_step``: orbax's restore and the port's reader give it bit for
    bit."""
    import functools

    from nnstreamer_tpu_torch.models import convert
    from nnstreamer_tpu_torch.models import mobilenet as tmb
    from nnstreamer_tpu_torch.parallel import mesh as tmesh
    from nnstreamer_tpu_torch.parallel import sharded as tsharded

    rng = np.random.default_rng(4)
    step, tp, to = tsharded.train_step(
        tmesh.make_mesh("data:1", tmesh.local_devices("cpu")[:1]),
        functools.partial(convert.mobilenet_v1_tree_apply,
                          dtype=torch.float32),
        tmb.mobilenet_v1_init(0, 10, 0.25))
    for _ in range(2):
        tp, to, _ = step(tp, to, rng.standard_normal(
            (4, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, 4).astype(np.int32))
    tree = tsharded.trained_tree(tp)
    root = str(tmp_path / "ckpts")
    path = tck.save_step(root, 7, tree)
    assert sorted(os.listdir(root)) == ["7"]
    assert_same(restore(path), tree)
    assert_same(tck.load_dir(path), tree)
    assert len(W.flat_leaves(tree)) == 5 + 13 * 2 * 5 + 2


def test_split_leaf_written_a_chunk_a_slice(tmp_path):
    """A :class:`ShardedLeaf` (as ``trained_tree(gather=False)`` gives a
    leaf split over ``model``) is written one chunk a slice, each slice
    from its own array; orbax restores the whole leaf."""
    from nnstreamer_tpu_torch.parallel.sharded import P, ShardedLeaf

    rng = np.random.default_rng(6)
    w = rng.standard_normal((1, 1, 8, 12)).astype(np.float32)
    bf = torch.randn(6, 4, generator=torch.Generator().manual_seed(1)) \
        .to(torch.bfloat16)
    tree = {"pw": ShardedLeaf([torch.from_numpy(w[..., :4].copy()),
                               torch.from_numpy(w[..., 4:8].copy()),
                               torch.from_numpy(w[..., 8:].copy())],
                              3, P(None, None, None, "model"), w.shape),
            "head": ShardedLeaf([bf[:, :2], bf[:, 2:]], 1, P(None, "model"),
                                (6, 4)),
            "b": np.ones(3, np.float32)}
    path = str(tmp_path / "ck")
    tck.save_dir(path, tree)
    keys = sorted(Ocdbt(path).list())
    assert [k for k in keys if not k.endswith(".zarray")] == [
        "b/0", "head/0.0", "head/0.1", "pw/0.0.0.0", "pw/0.0.0.1",
        "pw/0.0.0.2"]
    want = {"pw": w, "b": tree["b"],
            "head": np.asarray(jnp.asarray(bf.float().numpy(), jnp.bfloat16))}
    assert_same(_as_port(restore(path)), want)
    assert_same(tck.load_dir(path), want)


@pytest.mark.parametrize("form, field, value, match", [
    ("zarr v3", "use_zarr3", True, "use_zarr3"),
    ("blosc", "compressor", {"id": "blosc", "cname": "lz4"},
     "compressor 'blosc'"),
    ("gzip", "compressor", {"id": "gzip", "level": 1}, "compressor 'gzip'"),
    ("zlib", "compressor", {"id": "zlib", "level": 1}, "compressor 'zlib'"),
    ("lz4", "compressor", {"id": "lz4"}, "compressor 'lz4'"),
    ("filters", "filters", [{"id": "delta", "dtype": "<f4"}], "filters"),
    ("order F", "order", "F", "order 'F'"),
])
def test_writer_never_writes_a_refused_form(tmp_path, form, field, value,
                                            match):
    """The port's step is never in ``form``: zarr v2 in ``_METADATA``,
    zstd, no filters and order C in every ``.zarray``; the port's reader
    reads it back equal to the tree.  The same tree turned into ``form``
    by tensorstore reads bit-equal to orbax's restore where orbax reads
    that form (zarr v3, blosc, gzip, zlib, order F); where no tensorstore
    step can be in it (lz4, filters: tensorstore writes neither), the
    ``.zarray`` edited into it is refused, naming the field."""
    tree = {"x": np.arange(6, dtype=np.float32).reshape(2, 3),
            "y": {"z": np.ones((2, 2), np.int8)}, "s": 0.5}
    path = str(tmp_path / "ck")
    tck.save_dir(path, tree)
    meta = json.load(open(os.path.join(path, "_METADATA")))
    assert meta["use_zarr3"] is False and meta["use_ocdbt"] is True
    db = Ocdbt(path)
    zarrays = {k: json.loads(db.read(k)) for k in db.list()
               if k.endswith(".zarray")}
    db.close()
    assert len(zarrays) == 3
    for z in zarrays.values():
        assert z["zarr_format"] == 2 and z["compressor"]["id"] == "zstd"
        assert z["filters"] is None and z["order"] == "C"
    assert_same(load_orbax(path), tree)
    arrays = {"x": tree["x"], "y": {"z": tree["y"]["z"]}}
    files = str(tmp_path / "files")
    if form in ("lz4", "filters"):
        ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)) \
            .save(files, args=ocp.args.StandardSave(arrays))
        zpath = os.path.join(files, "x", ".zarray")
        z = json.load(open(zpath))
        z[field] = value
        json.dump(z, open(zpath, "w"))
        with pytest.raises(OrbaxFormatError, match=match):
            load_orbax(files)
        return
    if field == "use_zarr3":
        W.ts_step(files, arrays, True, _v3_meta(lambda a: [_LE]))
    else:
        W.ts_step(files, arrays, False, _v2_meta(
            value if field == "compressor" else None,
            value if field == "order" else "C"))
    assert json.load(open(os.path.join(files, "_METADATA")))[
        "use_zarr3"] is (field == "use_zarr3")
    assert_same(load_orbax(files), restore(files))
    assert_same(load_orbax(files), arrays)


@pytest.mark.parametrize("newest", ["jax", "port"])
def test_root_written_half_by_each_package(tmp_path, newest):
    """Steps 5 and 12 of one root, one written by each package: both
    packages' ``latest_step``/``resolve_step_dir`` pick 12, and both
    readers read each step as written."""
    root = str(tmp_path / "ckpts")
    trees = {5: {"w": np.full((3, 2), 5.0, np.float32)},
             12: {"w": np.full((3, 2), 12.0, np.float32)}}
    by = {12: newest, 5: "port" if newest == "jax" else "jax"}
    for step, who in by.items():
        if who == "jax":
            jck.save_orbax_step(root, step, trees[step])
        else:
            tck.save_step(root, step, trees[step])
    assert tck.list_steps(root) == jck.list_steps(root) == [5, 12]
    assert tck.latest_step(root) == jck.latest_step(root) == 12
    assert tck.resolve_step_dir(root, "latest") == \
        jck.resolve_step_dir(root, "latest") == (os.path.join(root, "12"),
                                                 "12")
    for step, tree in trees.items():
        path = tck.step_dir(root, step)
        assert_same(tck.load_dir(path), tree)
        assert_same(restore(path), tree)


def test_save_replaces_a_step_whole(tmp_path):
    """Saving over a step replaces the directory (an older step's
    ``params.safetensors`` goes with it) and leaves nothing hidden in
    the root."""
    from nnstreamer_tpu_torch.models.params_io import save_safetensors

    root = str(tmp_path / "ckpts")
    old = os.path.join(root, "3")
    os.makedirs(old)
    save_safetensors(os.path.join(old, tck.STEP_FILE),
                     {"w": np.zeros(2, np.float32)})
    assert_same(tck.load_dir(old), {"w": np.zeros(2, np.float32)})
    tck.save_step(root, 3, {"w": np.ones(2, np.float32)})
    assert sorted(os.listdir(old)) == ["_CHECKPOINT_METADATA", "_METADATA",
                                       "d", "manifest.ocdbt"]
    assert os.listdir(root) == ["3"]
    assert_same(restore(old), {"w": np.ones(2, np.float32)})
    with pytest.raises(ValueError, match="zero size"):
        tck.save_step(root, 4, {"w": np.zeros((0, 2), np.float32)})
    assert os.listdir(root) == ["3"]
    assert OW.step_bytes(old) == W.step_bytes(old) > 0


# -- 8. steps written across ranks, merged in one process ------------------------


def _rank_trees(ranks):
    """The tree each of ``ranks`` holds after a step across them (the
    replicated leaves alike on every rank, ``pw``'s slice ``i`` on the
    ``i``-th rank, as ``trained_tree(gather=False)`` gives them), and the
    whole tree as orbax restores it."""
    from nnstreamer_tpu_torch.parallel.sharded import (P, ModelGroup,
                                                       ShardedLeaf)

    rng = np.random.default_rng(24)
    n = len(ranks)
    pw = rng.standard_normal((1, 1, 6, 4 * n)).astype(np.float32)
    whole = {"rep": rng.standard_normal((8, 6)).astype(np.float32),
             "odd": rng.standard_normal((5, 3)).astype(np.float32),
             "bf": torch.randn(6, 2, generator=torch.Generator()
                               .manual_seed(3)).to(torch.bfloat16),
             "layers": [{"b": rng.standard_normal(4).astype(np.float16)},
                        {"n": np.int64(7)}],
             "s": 3, "f": 1.5, "e": {}, "pw": pw}
    trees = {}
    for i, r in enumerate(ranks):
        tree = dict(whole)
        tree["pw"] = ShardedLeaf(
            [torch.from_numpy(pw[..., 4 * i:4 * (i + 1)].copy())], 3,
            P(None, None, None, "model"), pw.shape,
            ModelGroup(0, [i], n, None))
        trees[r] = tree
    return trees, dict(whole, bf=np.asarray(jnp.asarray(
        whole["bf"].float().numpy(), jnp.bfloat16)))


def _merged_step(path, trees, keep=None):
    """The step every rank of ``trees`` writes, made in one process:
    each rank's share (``keep`` filters a rank's values) into its
    ``ocdbt.process_<rank>/`` store, then the lowest rank's merge and
    metadata.  Returns each rank's store keys."""
    tables = {r: OW.held(t) for r, t in trees.items()}
    plans = OW.plan(tables)
    stores, keys = {}, {}
    first = min(trees)
    for r, tree in trees.items():
        values = OW.share(tree, plans, r, r == first)
        if keep is not None:
            values = {k: v for k, v in values.items() if keep(r, k)}
        keys[r] = sorted(k.decode() for k in values)
        stores[r] = OW.write_store(os.path.join(path, OW.process_store(r)),
                                   values)
    OW.merge_stores(path, stores)
    OW.write_metadata(path, OW.tree_meta(trees[first], tables[first]))
    return keys


@pytest.mark.parametrize("ranks", [[0, 1], [0, 1, 2, 3]])
def test_process_stores_merged_read_by_orbax(tmp_path, ranks):
    """Two (four) hand-made process stores of one step, merged: orbax's
    restore and the port's reader give every leaf bit for bit; each
    chunk lies in one rank's store (the replicated ``rep`` split over the
    ranks along its first axis, ``odd`` whole on rank 0 where no axis
    divides, ``pw`` a slice a rank, every ``.zarray`` on rank 0), and the
    root's entries point into the ranks' data files."""
    trees, whole = _rank_trees(ranks)
    path = str(tmp_path / "step")
    keys = _merged_step(path, trees)
    assert sorted(os.listdir(path)) == sorted(
        ["d", "manifest.ocdbt"] + ["_CHECKPOINT_METADATA", "_METADATA"]
        + [f"ocdbt.process_{r}" for r in ranks])
    n = len(ranks)
    chunks = {r: [k for k in ks if not k.endswith(".zarray")]
              for r, ks in keys.items()}
    flat = [k for ks in chunks.values() for k in ks]
    assert len(flat) == len(set(flat))
    assert all(k.endswith(".zarray") for k in set(keys[0]) - set(chunks[0]))
    assert not any(k.endswith(".zarray") for r in ranks[1:] for k in keys[r])
    for i, r in enumerate(ranks):
        assert f"rep/{i}.0" in chunks[r] and f"pw/0.0.0.{i}" in chunks[r]
        assert ("odd/0.0" in chunks[r]) == (i == 0)
    db = Ocdbt(path)
    try:
        assert db.list() == sorted(k for ks in keys.values() for k in ks)
        files = {v[0] for v in db.values.values() if isinstance(v, tuple)}
        assert {f.split("/")[0] for f in files} <= {
            f"ocdbt.process_{r}" for r in ranks}
        assert json.loads(db.read("rep/.zarray"))["chunks"] == [8 // n, 6]
    finally:
        db.close()
    assert_same(_as_port(restore(path)), whole)
    assert_same(tck.load_dir(path), whole)


def test_a_left_out_rank_share_fails_the_read(tmp_path):
    """A rank whose chunks are left out of its store: the merged step
    misses them, and both readers raise on the missing chunk."""
    trees, _ = _rank_trees([0, 1])
    path = str(tmp_path / "step")
    _merged_step(path, trees, keep=lambda r, k: r == 0
                 or not k.startswith(b"pw/"))
    with pytest.raises(OrbaxFormatError, match=r"chunk 'pw/0\.0\.0\.1' is "
                       r"missing"):
        tck.load_dir(path)
    with pytest.raises(Exception):
        restore(path)


def test_the_plan_refuses_what_it_cannot_write():
    """Every rank derives one plan: trees of other leaves, a leaf of
    another shape on one rank, a zero-size leaf and a slice no rank holds
    are refused, each naming the leaf."""
    trees, _ = _rank_trees([0, 1])
    tables = {r: OW.held(t) for r, t in trees.items()}
    with pytest.raises(ValueError, match=r"trees differ: rank 1 holds "
                       r"\['x'\] and not \[\]"):
        OW.plan({0: tables[0], 1: tables[1] + [("x", ("scalar", (), "<i8",
                                                      -1, 1, (0,)))]})
    other = dict(trees[1], odd=np.zeros((5, 4), np.float32))
    with pytest.raises(ValueError, match=r"odd differs between the ranks"):
        OW.plan({0: tables[0], 1: OW.held(other)})
    zero = {r: OW.held(dict(t, z=np.zeros((0, 3), np.float32)))
            for r, t in trees.items()}
    with pytest.raises(ValueError, match="zero size: z"):
        OW.plan(zero)
    with pytest.raises(ValueError, match=r"pw: slices \[1\] of 2 are held "
                       r"by no rank"):
        OW.plan({0: tables[0], 1: OW.held(trees[0])})


def test_the_plan_splits_a_slice_over_its_holders():
    """Where two ranks hold each slice (four ranks on ``model:2,data:4``:
    slice 0 on ranks 0 and 1), each slice splits over its two holders
    along its first axis they divide; every key once."""
    from nnstreamer_tpu_torch.parallel.sharded import (P, ModelGroup,
                                                       ShardedLeaf)

    w = np.arange(4 * 6, dtype=np.float32).reshape(4, 6)
    trees = {r: {"w": ShardedLeaf([w[:, 3 * (r // 2):3 * (r // 2 + 1)]], 1,
                                  P(None, "model"), w.shape,
                                  ModelGroup(0, [r // 2], 2, None))}
             for r in range(4)}
    plans = OW.plan({r: OW.held(t) for r, t in trees.items()})
    lp = plans["w"]
    assert lp.chunks == (2, 3)
    assert [(p.writer, p.key) for p in lp.pieces] == [
        (0, "w/0.0"), (1, "w/1.0"), (2, "w/0.1"), (3, "w/1.1")]
    got = np.zeros_like(w)
    for r, tree in trees.items():
        for k, v in OW.share(tree, plans, r, r == 0).items():
            if not k.endswith(b".zarray"):
                i, j = map(int, k.decode().split("/")[1].split("."))
                got[2 * i:2 * i + 2, 3 * j:3 * j + 3] = \
                    v.view(np.float32).reshape(2, 3)
    assert got.tobytes() == w.tobytes()


def test_one_rank_groups_write_as_one_process(tmp_path):
    """A group of one rank (and no group) writes as one process does: no
    process store, one chunk a leaf."""
    from nnstreamer_tpu_torch.parallel.multihost import Subgroup

    tree = {"w": np.arange(8, dtype=np.float32).reshape(4, 2), "s": 2}
    for group in (None, Subgroup([0])):
        path = str(tmp_path / f"ck{group is None}")
        tck.save_dir(path, tree, group=group)
        assert sorted(os.listdir(path)) == ["_CHECKPOINT_METADATA",
                                            "_METADATA", "d",
                                            "manifest.ocdbt"]
        assert_same(tck.load_dir(path), tree)
        assert_same(restore(path), tree)


# -- 9. the committed forms and the tests' zarr v3 writer ----------------------


def _form_facts(form, path):
    """What makes the committed step ``form`` the form it names."""
    meta = json.load(open(os.path.join(path, "_METADATA")))
    db = Ocdbt(path)
    try:
        keys = db.list()
        arrays = {k.rsplit("/", 1)[0]: json.loads(db.read(k)) for k in keys
                  if k.endswith(("/zarr.json", "/.zarray"))}
        chunks = {k: db.read(k) for k in keys
                  if not k.endswith(("/zarr.json", "/.zarray"))}
    finally:
        db.close()
    assert len(arrays) == len(W.flat_leaves(W.forms_tree()))
    assert meta["use_zarr3"] is form.startswith("zarr3")
    if form.startswith("zarr3"):
        codecs = {n: [c["name"] for c in a["codecs"]]
                  for n, a in arrays.items()}
    if form.startswith("zarr3_orbax"):
        inner = {c["name"] for a in arrays.values()
                 for c in a["codecs"][0]["configuration"]["codecs"]}
        assert set(map(tuple, codecs.values())) == {("sharding_indexed",)}
        assert inner == ({"bytes"} if form.endswith("raw")
                         else {"bytes", "zstd"})
        assert "dense.w/c/0/0" in chunks and "step/c" in chunks
    elif form == "zarr3_inner_start":
        conf = arrays["dense.w"]["codecs"][0]["configuration"]
        assert conf["index_location"] == "start"
        assert conf["chunk_shape"] == [22, 32]
        assert arrays["dense.w"]["chunk_grid"]["configuration"][
            "chunk_shape"] == [44, 64]
    elif form == "zarr3_transpose_gzip_crc32c":
        assert codecs["dense.w"] == ["transpose", "bytes", "gzip", "crc32c"]
        assert "dense.w/c.1.1" in chunks
    elif form == "zarr2_blosc":
        for name, want in W.BLOSC_LEAVES.items():
            assert arrays[name]["compressor"]["cname"] == want["cname"]
        heads = {k: v[:16] for k, v in chunks.items()}
        w, q = heads["dense.w/0.0"], heads["quant/0.0"]
        assert w[2] & 0x04 and w[2] >> 5 == 1          # lz4, bitshuffle
        assert q[2] >> 5 == 4 and int.from_bytes(q[8:12], "little") < \
            int.from_bytes(q[4:8], "little")           # several blocks
        assert {h[2] >> 5 for h in heads.values()} == {0, 1, 2, 3, 4}
    elif form == "zarr2_bz2_order_f":
        assert {a["compressor"]["id"] for a in arrays.values()} == {"bz2"}
        assert arrays["dense.w"]["order"] == "F"
    elif form == "ocdbt_numbered":
        names = os.listdir(path)
        assert sum(n.startswith("manifest.0") for n in names) >= 2
        assert db.generation >= 2


@pytest.mark.parametrize("form", sorted(W.FORMS))
def test_committed_form_reads_bit_equal(form):
    """Each committed step under ``tests/data/orbax_forms/`` is the form
    it names, at most 256 KB, and reads bit-equal to its seeded tree and
    to orbax's restore."""
    path = os.path.join(W.FORMS_DIR, form)
    _form_facts(form, path)
    assert W.step_bytes(path) <= 256 * 1024
    got = tck.load_dir(path)
    assert_same(got, W.forms_tree())
    assert_same(got, restore(path))


def test_committed_forms_stay_small():
    total = sum(W.step_bytes(os.path.join(W.FORMS_DIR, f)) for f in W.FORMS)
    assert sorted(os.listdir(W.FORMS_DIR)) == sorted(W.FORMS)
    assert total <= 1536 * 1024


@pytest.mark.parametrize("inner", [False, True])
def test_zarr3_writer_steps_restore_in_orbax(tmp_path, inner):
    """The tests' zarr v3 writer (``form="zarr3"``, what the card's smoke
    test writes its full-width step with): orbax's restore reads every
    leaf bit for bit — bf16 torch leaves, Python numbers, 0-d arrays,
    empty nodes —, and so does the port's reader; ``inner`` splits the
    shards into inner chunks."""
    rng = np.random.default_rng(31)
    tree = {"w": rng.standard_normal((12, 20)).astype(np.float32),
            "bf": torch.randn(8, 6, generator=torch.Generator().manual_seed(
                2)).to(torch.bfloat16),
            "s": 2.5, "i": 7, "z": np.array(3, np.int16),
            "l": [np.arange(4, dtype=np.uint8), {}],
            "c": (rng.standard_normal(4) * 1j).astype(np.complex64)}
    path = str(tmp_path / "ck")
    W.write_orbax_step(path, tree, form="zarr3",
                       inner={"w": (4, 5), "bf": (2, 6)} if inner else None)
    meta = json.load(open(os.path.join(path, "_METADATA")))
    assert meta["use_zarr3"] is True
    db = Ocdbt(path)
    assert "w/c/0/0" in db.list() and "s/c" in db.list()
    db.close()
    want = restore(path)
    assert_same(tck.load_dir(path), want)
    assert_same(_as_port(want), dict(tree, bf=np.asarray(jnp.asarray(
        tree["bf"].float().numpy(), jnp.bfloat16))))
