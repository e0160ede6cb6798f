"""The gRPC bridge of the port (``nnstreamer_tpu_torch.edge.grpc_bridge``)
against the JAX package's.

``tests/test_grpc.py`` replayed on the port (the four role combinations
over localhost for each codec, a server source stopping without a peer),
then the port's own cases: a JAX sink serving a port source and the
reverse, one host read per card tensor at the sink (a fake card tag:
``obs.transfer.CARD_TYPES`` widened to ``("cuda", "cpu")``), and the
``grpc_roundtrip`` golden byte-exact.  Needs ``grpcio``.  The replay
waits for the ``RecvTensors`` subscriber where the JAX test sleeps 0.3 s:
a frame the serving sink renders before a subscriber attaches is skipped,
and under load the sleep was too short for the port.
"""

import pytest

pytest.importorskip("grpc")

from torch_replay import replay  # noqa: E402

replay("test_grpc.py", globals(), subs=(
    ("time.sleep(0.3)  # let the RecvTensors subscription attach",
     "_wait_for_subscriber(snk)"),
))


# -- the port's own cases ------------------------------------------------------

import os  # noqa: E402
import time as _time  # noqa: E402
from fractions import Fraction  # noqa: E402

import numpy as _np  # noqa: E402
import torch  # noqa: E402

import golden_cases  # noqa: E402
import nnstreamer_tpu.core as jcore  # noqa: E402
from nnstreamer_tpu.runtime import parse_launch as j_parse  # noqa: E402
from nnstreamer_tpu_torch.core import Buffer as TBuffer  # noqa: E402
from nnstreamer_tpu_torch.core import TensorsSpec as TSpec  # noqa: E402
from nnstreamer_tpu_torch.obs import transfer as txfer  # noqa: E402
from nnstreamer_tpu_torch.runtime import parse_launch as t_parse  # noqa: E402
from torch_replay import port_function  # noqa: E402


def _wait_for_subscriber(sink_el, timeout=20.0):
    """Until a ``RecvTensors`` stream is attached to the serving sink (a
    frame rendered before that is skipped: nobody is listening)."""
    deadline = _time.monotonic() + timeout
    while not sink_el._subscribers:
        assert _time.monotonic() < deadline, "no RecvTensors subscriber"
        _time.sleep(0.01)


PKG = {
    "jax": dict(parse=j_parse, buf=jcore.Buffer.of, spec=jcore.TensorsSpec),
    "port": dict(parse=lambda d: t_parse(d, device="cpu"), buf=TBuffer.of,
                 spec=TSpec),
}


@pytest.mark.parametrize("idl", ["protobuf", "flexbuf"])
@pytest.mark.parametrize("sender,receiver", [("jax", "port"),
                                             ("port", "jax")])
def test_one_package_serves_the_other(sender, receiver, idl):
    """A ``tensor_sink_grpc server=true`` of one package streams to a
    ``tensor_src_grpc server=false`` of the other: the frames arrive in
    order with their dtypes and bytes."""
    snd, rcv = PKG[sender], PKG[receiver]
    frames = [(_np.random.default_rng(i).standard_normal((2, 4)).astype(
        _np.float32), _np.arange(3, dtype=_np.int32) + i) for i in range(3)]
    p1 = snd["parse"](f"appsrc name=src ! tensor_sink_grpc name=gs "
                      f"server=true port=0 idl={idl}")
    p1["src"].spec = snd["spec"].parse("4:2,3", "float32,int32",
                                       rate=Fraction(30))
    p1.start()
    try:
        p2 = rcv["parse"](f"tensor_src_grpc name=gr server=false "
                          f"port={p1['gs'].bound_port} idl={idl} "
                          "num-buffers=3 ! appsink name=out")
        p2.start()
        try:
            _wait_for_subscriber(p1["gs"])
            for a, b in frames:
                p1["src"].push_buffer(snd["buf"](a, b))
            got = [p2["out"].pull(timeout=20) for _ in frames]
        finally:
            p2.stop()
    finally:
        p1.stop()
    for g, (a, b) in zip(got, frames):
        assert g is not None
        assert [t.tobytes() for t in g.tensors] == [a.tobytes(), b.tobytes()]
        assert [t.np().dtype for t in g.tensors] == [_np.float32, _np.int32]


def test_card_frames_drain_once_per_tensor(monkeypatch):
    """The sink encodes a card buffer as the wire codecs do: one ``d2h``
    per tensor, and the frame's bytes equal the host frame's."""
    monkeypatch.setattr(txfer, "CARD_TYPES", ("cuda", "cpu"))
    txfer.LEDGER.clear()
    p1 = t_parse("appsrc name=src ! tensor_sink_grpc name=gs server=true "
                 "port=0 idl=protobuf", device="cpu")
    p1.name = "grpc-card"
    p1["src"].spec = TSpec.parse("4:2", "float32")
    p1.start()
    frames = [torch.full((2, 4), float(i)) for i in range(3)]
    try:
        p2 = t_parse(f"tensor_src_grpc server=false "
                     f"port={p1['gs'].bound_port} num-buffers=3 ! "
                     "appsink name=out", device="cpu")
        p2.start()
        try:
            _wait_for_subscriber(p1["gs"])
            for f in frames:
                p1["src"].push_buffer(TBuffer.of(f))
            got = [p2["out"].pull(timeout=20) for _ in frames]
            d2h = txfer.LEDGER.totals(pipeline="grpc-card", direction="d2h")
        finally:
            p2.stop()
    finally:
        p1.stop()
        txfer.LEDGER.clear()
    assert d2h == (3, 3 * 32)
    for g, f in zip(got, frames):
        assert g.tensors[0].tobytes() == f.numpy().tobytes()


def test_golden_grpc_roundtrip(tmp_path):
    """``case_grpc_roundtrip`` (``tests/golden_cases.py``) with the port's
    elements and ``parse_launch(device="cpu")``."""
    case = port_function(golden_cases.case_grpc_roundtrip, {
        "parse_launch": lambda desc: t_parse(desc, device="cpu"),
        "TensorsSpec": TSpec, "Buffer": TBuffer})
    out = str(tmp_path / "grpc_roundtrip.out")
    case(out)
    with open(os.path.join(golden_cases.GOLDEN_DIR,
                           "grpc_roundtrip.golden"), "rb") as f:
        assert open(out, "rb").read() == f.read()
