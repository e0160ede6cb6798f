"""The port's wire codecs, ``tensor_converter`` and font overlay against
the JAX package's, on the CPU.

The cases of ``tests/test_wirefmt.py`` (codecs, converter sub-plugins,
wire decoders, the python3 converter and decoder, the font overlay)
replayed on the port, each input through both packages:

- FlexBuffers, FlatBuffers and protobuf payloads byte-equal to the JAX
  package's pure-Python codec (its C++ mirror switched off), and decode ∘
  encode the identity on both sides;
- the converter sub-plugins and wire decoders in a pipeline, equal to
  the JAX package's output (tensors, dtype, pts, format);
- ``mode=custom-code:`` and ``mode=custom-script:`` converters and the
  python3 decoder;
- ``tensor_converter``'s media parsers — video (with and without the
  4-byte row padding), audio, text, octet, ``frames-per-tensor`` and the
  flexible → static path — equal to the JAX package's tensors byte for
  byte;
- the glyph masks and the labeled box canvas equal to the JAX package's
  (both packages see the same PIL in one process).

Without ``flatbuffers`` the port's flexbuf/flatbuf codecs raise an
``ImportError`` naming the package while protobuf keeps working.
"""

import builtins
import textwrap
from fractions import Fraction
from types import SimpleNamespace

import numpy as np
import pytest

import nnstreamer_tpu.converters as jconv
import nnstreamer_tpu.core as jcore
import nnstreamer_tpu.elements.basic as jbasic
import nnstreamer_tpu.runtime as jruntime
import nnstreamer_tpu_torch.converters as tconv
import nnstreamer_tpu_torch.core as tcore
import nnstreamer_tpu_torch.elements.basic as tbasic
import nnstreamer_tpu_torch.runtime as truntime
from nnstreamer_tpu.converters import codecs as jcodecs
from nnstreamer_tpu.decoders import boxutil as jbox
from nnstreamer_tpu.decoders import find_decoder as jfind_decoder
from nnstreamer_tpu.decoders import font as jfont
from nnstreamer_tpu.runtime.registry import make as jmake
from nnstreamer_tpu_torch.converters import codecs as tcodecs
from nnstreamer_tpu_torch.decoders import boxutil as tbox
from nnstreamer_tpu_torch.decoders import find_decoder as tfind_decoder
from nnstreamer_tpu_torch.decoders import font as tfont
from nnstreamer_tpu_torch.runtime.registry import make as tmake

PKGS = {
    "jax": SimpleNamespace(
        core=jcore, basic=jbasic, conv=jconv, codecs=jcodecs,
        make=jmake, find_decoder=jfind_decoder,
        pipeline=lambda: jruntime.Pipeline()),
    "port": SimpleNamespace(
        core=tcore, basic=tbasic, conv=tconv, codecs=tcodecs,
        make=tmake, find_decoder=tfind_decoder,
        pipeline=lambda: truntime.Pipeline(device="cpu")),
}

WIRES = ["flexbuf", "flatbuf", "protobuf"]
MIMES = {"flexbuf": "other/flexbuf", "flatbuf": "other/flatbuf-tensor",
         "protobuf": "other/protobuf-tensor"}


@pytest.fixture(autouse=True)
def _python_codec(monkeypatch):
    """The JAX package's protobuf codec tries its C++ mirror first; the
    port has only the Python path, so the JAX side runs that path too."""
    monkeypatch.setattr(jcodecs, "_native_encode", lambda *a: None)
    monkeypatch.setattr(jcodecs, "_native_decode", lambda *a: None)


def _sample(k):
    return k.core.Buffer.of(
        np.arange(24, dtype=np.float32).reshape(2, 3, 4),
        np.array([7, 8, 9], dtype=np.uint8),
        np.array([[1.5, -2.5]], dtype=np.float64),
        np.array([-3, 4], dtype=np.int16))


def _tensors(buf):
    return [(t.np().dtype.str, t.np().shape, t.np().tobytes())
            for t in buf.tensors]


@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("rate", [Fraction(30), Fraction(0, 1)])
def test_codec_bytes_equal_jax_and_roundtrip(wire, rate):
    payloads = {}
    for name, k in PKGS.items():
        b = _sample(k)
        enc = getattr(k.codecs, f"{wire}_encode")
        dec = getattr(k.codecs, f"{wire}_decode")
        payloads[name] = enc(b, b.spec(rate=rate))
        out, ospec = dec(payloads[name])
        assert _tensors(out) == _tensors(b)
        assert ospec.rate == rate
    assert payloads["port"] == payloads["jax"]
    # each side decodes the other's bytes to the same tensors
    out, _ = getattr(tcodecs, f"{wire}_decode")(payloads["jax"])
    assert _tensors(out) == _tensors(_sample(PKGS["port"]))


def test_flexible_format_and_names_on_the_wire():
    for wire in WIRES:
        got = []
        for k in PKGS.values():
            spec = k.core.TensorSpec.from_shape((2,), np.int32,
                                                name="counts")
            t = k.core.Tensor(np.array([5, 6], np.int32), spec)
            b = k.core.Buffer(tensors=[t],
                              format=k.core.TensorFormat.FLEXIBLE)
            data = getattr(k.codecs, f"{wire}_encode")(b, None)
            out, ospec = getattr(k.codecs, f"{wire}_decode")(data)
            got.append((data, int(ospec.format.value),
                        [t.spec.name for t in out.tensors]))
        assert got[0] == got[1], wire


def test_protobuf_unpacked_dims_and_unknown_fields_match_jax():
    # a hand-written payload: unpacked dims, an unknown varint field and
    # an unknown fixed32 field must decode the same in both packages
    t = bytearray()
    t += jcodecs._tag(2, 0) + jcodecs._varint(7)            # float32
    for d in (2, 1):
        t += jcodecs._tag(3, 0) + jcodecs._varint(d)        # unpacked
    t += jcodecs._tag(9, 0) + jcodecs._varint(99)           # unknown
    t += jcodecs._tag(10, 5) + b"\x01\x02\x03\x04"          # unknown
    t += jcodecs._ld(4, np.array([1.0, 2.0], np.float32).tobytes())
    data = jcodecs._ld(3, bytes(t))
    a, _ = jcodecs.protobuf_decode(data)
    b, _ = tcodecs.protobuf_decode(data)
    assert _tensors(a) == _tensors(b)


def test_flatbuffers_missing_names_the_package(monkeypatch):
    real_import = builtins.__import__

    def no_flatbuffers(name, *a, **kw):
        if name == "flatbuffers" or name.startswith("flatbuffers."):
            raise ImportError("No module named 'flatbuffers'")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_flatbuffers)
    b = _sample(PKGS["port"])
    for enc in (tcodecs.flexbuf_encode, tcodecs.flatbuf_encode):
        with pytest.raises(ImportError, match="flatbuffers"):
            enc(b, None)
    data = tcodecs.protobuf_encode(b, None)
    out, _ = tcodecs.protobuf_decode(data)
    assert _tensors(out) == _tensors(b)


# -- converter sub-plugins and wire decoders in pipelines ---------------------

def test_converter_registry_matches_jax():
    assert tconv.list_converters() == jconv.list_converters()
    assert tconv.registered_mimes() == jconv.registered_mimes()
    for mime in MIMES.values():
        assert tconv.find_converter(mime).NAME == \
            jconv.find_converter(mime).NAME


def _run(k, src_props, conv_props, pushes, el="tensor_converter"):
    p = k.pipeline()
    src = k.basic.AppSrc(name="src", **src_props)
    conv = k.make(el, el_name="conv", **conv_props)
    sink = k.basic.AppSink(name="out")
    p.add(src, conv, sink).link(src, conv, sink)
    with p:
        for b in pushes(k):
            src.push_buffer(b)
        src.end_of_stream()
        assert p.wait_eos(timeout=30)
    out = []
    while (b := sink.pull(timeout=0)) is not None:
        out.append(b)
    return out


def _same_outputs(outs):
    a, b = outs["jax"], outs["port"]
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert _tensors(x) == _tensors(y)
        assert (x.pts, int(x.format.value)) == (y.pts, int(y.format.value))


@pytest.mark.parametrize("wire", WIRES)
def test_pipeline_wire_to_tensors_matches_jax(wire):
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    outs = {}
    for name, k in PKGS.items():
        enc = getattr(k.codecs, f"{wire}_encode")
        orig = k.core.Buffer.of(arr)
        payload = enc(orig, orig.spec(rate=Fraction(30)))
        outs[name] = _run(
            k, {"caps": MIMES[wire]}, {},
            lambda k, payload=payload: [k.core.Buffer.of(
                np.frombuffer(payload, np.uint8), pts=1234)])
    _same_outputs(outs)
    assert outs["port"][0].format == tcore.TensorFormat.FLEXIBLE
    np.testing.assert_array_equal(outs["port"][0].tensors[0].np(), arr)


@pytest.mark.parametrize("wire", WIRES)
def test_pipeline_decoder_to_converter_roundtrip_matches_jax(wire):
    arr = np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3)
    outs = {}
    for name, k in PKGS.items():
        spec = k.core.TensorsSpec.from_shapes([(2, 3)], np.float32,
                                              rate=Fraction(30))
        p = k.pipeline()
        src = k.basic.AppSrc(name="src", spec=spec)
        dec = k.make("tensor_decoder", el_name="dec", mode=wire)
        conv = k.make("tensor_converter", el_name="conv")
        sink = k.basic.AppSink(name="out")
        p.add(src, dec, conv, sink).link(src, dec, conv, sink)
        with p:
            src.push_buffer(k.core.Buffer.of(arr, pts=77))
            src.end_of_stream()
            assert p.wait_eos(timeout=30)
            outs[name] = [sink.pull(timeout=1)]
    _same_outputs(outs)
    np.testing.assert_array_equal(outs["port"][0].tensors[0].np(), arr)


@pytest.mark.parametrize("wire", WIRES)
def test_wire_decoder_payload_equals_jax(wire):
    got = {}
    for name, k in PKGS.items():
        d = k.find_decoder(wire)()
        b = _sample(k)
        spec = b.spec(rate=Fraction(30))
        got[name] = (d.out_caps(spec).first().mime,
                     d.decode(b, spec).tensors[0].tobytes())
    assert got["port"] == got["jax"]
    assert got["port"][0] == MIMES[wire]


def test_custom_code_mode_matches_jax():
    def conv_fn(k):
        return lambda buf: k.core.Buffer.of(
            buf.tensors[0].np().astype(np.float32) * 2.0)

    outs = {}
    for name, k in PKGS.items():
        k.conv.register_custom("twire_x2", conv_fn(k))
        try:
            outs[name] = _run(
                k, {"caps": "application/octet-stream"},
                {"mode": "custom-code:twire_x2"},
                lambda k: [k.core.Buffer.of(np.arange(4, dtype=np.uint8))])
        finally:
            assert k.conv.unregister_custom("twire_x2")
    _same_outputs(outs)
    np.testing.assert_array_equal(outs["port"][0].tensors[0].np(),
                                  np.arange(4, dtype=np.float32) * 2)


@pytest.mark.parametrize("ret", ["tuple", "list"])
def test_custom_script_mode_matches_jax(tmp_path, ret):
    script = tmp_path / f"conv_{ret}.py"
    body = ("info = [((len(raw),), np.uint8)]\n"
            "        return info, [raw[::-1].copy()], 10, 1"
            if ret == "tuple" else
            "return [raw.astype(np.int16).reshape(1, -1) * 3]")
    script.write_text(textwrap.dedent("""\
        import numpy as np

        class CustomConverter:
            def convert(self, arrays):
                raw = arrays[0]
                %s
    """) % body)
    outs = {name: _run(k, {"caps": "application/octet-stream"},
                       {"mode": f"custom-script:{script}"},
                       lambda k: [k.core.Buffer.of(
                           np.array([1, 2, 3], np.uint8), pts=5)])
            for name, k in PKGS.items()}
    _same_outputs(outs)


def test_python3_decoder_script_matches_jax(tmp_path):
    script = tmp_path / "dec.py"
    script.write_text(textwrap.dedent("""\
        class CustomDecoder:
            def getOutCaps(self):
                return bytes('application/octet-stream', 'UTF-8')

            def decode(self, raw_data, in_info, rate_n, rate_d):
                assert in_info[0].getDims()[0] == 4  # innermost dim
                head = bytes([rate_n, rate_d, len(in_info)])
                return head + b''.join(bytes(r) for r in raw_data)
    """))
    got = {}
    for name, k in PKGS.items():
        d = k.find_decoder("python3")()
        d.set_option(0, str(script))
        b = k.core.Buffer.of(np.arange(8, dtype=np.uint8).reshape(2, 4),
                             np.array([1.0], np.float32))
        spec = b.spec(rate=Fraction(30))
        got[name] = (d.out_caps(spec).first().mime,
                     d.decode(b, spec).tensors[0].tobytes())
    assert got["port"] == got["jax"]
    assert got["port"][1][:3] == bytes([30, 1, 2])


# -- tensor_converter's media parsers ----------------------------------------

def _wire_bytes(k, f, pts):
    """A buffer of raw bytes, as a media source hands them on (the row
    padding is stripped only from such payloads)."""
    spec = k.core.TensorSpec.from_shape((f.nbytes,), np.uint8)
    return k.core.Buffer(tensors=[k.core.Tensor(f.tobytes(), spec)],
                         pts=pts)


def _media(caps, frames, props=None, raw=True):
    outs = {}
    for name, k in PKGS.items():
        outs[name] = _run(k, {"caps": caps}, props or {},
                          lambda k: [_wire_bytes(k, f, i) if raw
                                     else k.core.Buffer.of(f, pts=i)
                                     for i, f in enumerate(frames)])
    _same_outputs(outs)
    return outs["port"]


@pytest.mark.parametrize("fmt,ch,w", [("RGB", 3, 6), ("RGB", 3, 5),
                                      ("GRAY8", 1, 7), ("RGBA", 4, 5),
                                      ("BGRx", 4, 3)])
def test_video_parser_matches_jax(fmt, ch, w):
    h = 4
    rng = np.random.default_rng(ch * 10 + w)
    row = w * ch
    pad = (4 - row % 4) % 4 if fmt in ("RGB", "BGR", "GRAY8") else 0
    frames = [rng.integers(0, 256, h * (row + pad), dtype=np.uint8)
              for _ in range(2)]
    caps = f"video/x-raw,format={fmt},width={w},height={h},framerate=30/1"
    out = _media(caps, frames)
    want = frames[0].reshape(h, row + pad)[:, :row].reshape(1, h, w, ch)
    np.testing.assert_array_equal(out[0].tensors[0].np(), want)


def test_video_frames_per_tensor_matches_jax():
    frames = [np.full(2 * 4 * 3, i, np.uint8) for i in range(5)]
    out = _media("video/x-raw,format=RGB,width=4,height=2,framerate=30/1",
                 frames, {"frames_per_tensor": 2})
    assert len(out) == 2                       # the partial batch drops
    assert out[0].tensors[0].np().shape == (2, 2, 4, 3)


@pytest.mark.parametrize("fmt,dtype", [("S16LE", np.int16),
                                       ("F32LE", np.float32),
                                       ("U8", np.uint8)])
def test_audio_parser_matches_jax(fmt, dtype):
    rng = np.random.default_rng(7)
    frames = [(rng.standard_normal(2 * 8) * 100).astype(dtype)
              for _ in range(3)]
    out = _media(f"audio/x-raw,format={fmt},channels=2,samples=8,"
                 "rate=16000,framerate=10/1",
                 [np.frombuffer(f.tobytes(), np.uint8) for f in frames])
    np.testing.assert_array_equal(out[1].tensors[0].np().reshape(-1),
                                  frames[1])


def test_audio_input_dim_override_matches_jax():
    frames = [np.arange(12, dtype=np.int16).view(np.uint8)]
    _media("audio/x-raw,format=S16LE,channels=1,framerate=10/1", frames,
           {"input_dim": "3:4"})


def test_text_parser_matches_jax():
    frames = [np.frombuffer(s.encode().ljust(16, b"\0"), np.uint8)
              for s in ("hello", "pipeline text")]
    out = _media("text/x-raw,format=utf8,framerate=10/1", frames,
                 {"input_dim": "16"})
    assert out[0].tensors[0].np().tobytes().rstrip(b"\0") == b"hello"


@pytest.mark.parametrize("dim,typ", [("4:3", "uint8"), ("3", "float32"),
                                     ("2:2", "int16")])
def test_octet_parser_matches_jax(dim, typ):
    n = int(np.prod([int(d) for d in dim.split(":")])) * \
        np.dtype(typ).itemsize
    frames = [np.arange(n, dtype=np.uint8) + i for i in range(2)]
    _media("application/octet-stream", frames,
           {"input_dim": dim, "input_type": typ})


def test_flexible_to_static_matches_jax():
    outs = {}
    for name, k in PKGS.items():
        fmt = k.core.TensorFormat.FLEXIBLE
        outs[name] = _run(
            k, {"spec": k.core.TensorsSpec(format=fmt)},
            {"input_dim": "4:1", "input_type": "float32"},
            lambda k, fmt=fmt: [k.core.Buffer.of(
                np.array([[0.5, 1.5, -2.5, 4.0]], np.float32), format=fmt,
                pts=3)])
    _same_outputs(outs)
    assert outs["port"][0].format == tcore.TensorFormat.STATIC


def test_host_array_frames_match_jax():
    """A host array of the frame's own type takes the zero-copy reshape
    instead of the raw-bytes path."""
    frames = [np.arange(12, dtype=np.float32) * i for i in range(2)]
    _media("application/octet-stream", frames,
           {"input_dim": "4:3", "input_type": "float32"}, raw=False)


def test_octet_without_dims_refused_in_both():
    for k, err in ((PKGS["jax"], jruntime.NegotiationError),
                   (PKGS["port"], truntime.NegotiationError)):
        p = k.pipeline()
        src = k.basic.AppSrc(name="src", caps="application/octet-stream")
        conv = k.make("tensor_converter", el_name="conv")
        sink = k.basic.AppSink(name="out")
        p.add(src, conv, sink).link(src, conv, sink)
        with pytest.raises(err, match="input-dim"):
            p.start()
        p.stop()


# -- font overlay ---------------------------------------------------------------

@pytest.mark.parametrize("text", ["A1", "person", "traffic light", " x "])
def test_text_mask_matches_jax(text):
    np.testing.assert_array_equal(tfont.text_mask(text),
                                  jfont.text_mask(text))
    assert tfont.text_mask(text).shape[0] == tfont.GLYPH_H == 13


@pytest.mark.parametrize("x,y", [(2, 2), (-5, -5), (100, 100), (55, 25)])
def test_draw_text_matches_jax_and_clips(x, y):
    frames = []
    for font in (jfont, tfont):
        f = np.zeros((32, 64, 4), np.uint8)
        font.draw_text(f, x, y, "XYZ7", (255, 0, 0, 255))
        frames.append(f)
    np.testing.assert_array_equal(frames[0], frames[1])
    assert tfont.glyph_source() in ("PIL", "blocks")


def test_label_anchor_matches_jax():
    for bx, by in ((0, 0), (10, 14), (10, 13), (3, 40)):
        assert tfont.label_anchor(bx, by) == jfont.label_anchor(bx, by)


def test_labeled_boxes_match_jax():
    canvases = []
    for box in (jbox, tbox):
        dets = []
        for i, (x, y, c) in enumerate(((0.25, 0.5, 1), (0.05, 0.02, 7),
                                       (0.6, 0.3, 2))):
            d = box.Detection(x=x, y=y, w=0.3, h=0.3, class_id=c,
                              score=0.9 - i / 10)
            d.label = ("cat", "traffic light", "")[i]
            dets.append(d)
        plain = box.draw_boxes(dets, 64, 48)
        labeled = box.draw_boxes(dets, 64, 48, labels=True)
        assert (labeled != plain).any()
        canvases.append(labeled)
    np.testing.assert_array_equal(canvases[0], canvases[1])
