"""The ``tensorflow`` (frozen GraphDef) importer of the port against the JAX
package's.

The reference's mnist.pb and conv_actions_frozen.pb are not in the
repository, so ``tests/torch_model_files.py`` writes graphs in their op
sets from seeded weights: a 784→10 softmax regression, and the
speech-commands ``conv`` graph (DecodeWav → AudioSpectrogram → Mfcc → two
Conv2D/Relu, MaxPool → MatMul → Add → Softmax over 12 labels, 8 filters
here where the original has 64).  Both packages' filters take the same
files and inputs from a numpy seed: the mnist graph within 1e-6 at batch
1, 2 and 256 (batch-flex), the speech graph within 1e-5 on seeded clips.
Where ``tensorflow`` imports, TF's own session runs the same files: mnist
within 1e-6; AudioSpectrogram within 1e-5 of its largest magnitude; the
convnet after Mfcc within 1e-5 with TF's Mfcc output replaced by the
port's.  The Mfcc stage itself is the JAX package's reimplementation, which
both packages share and which does not reproduce TF's op (logged in
ROADMAP queue C); that gap is measured here, not hidden.
``tests/test_tf_import.py``'s cases that need no asset run on the port by
``torch_replay``.
"""

import numpy as np
import pytest
import torch_model_files as mf
from torch_replay import replay

from nnstreamer_tpu.core import Buffer as JBuffer
from nnstreamer_tpu.core import TensorsSpec as JSpec
from nnstreamer_tpu.elements.filter import FilterSingle as JSingle
from nnstreamer_tpu.filters import tf_import as jtf
from nnstreamer_tpu.runtime import parse_launch as jparse
from nnstreamer_tpu_torch.core import Buffer, TensorsSpec
from nnstreamer_tpu_torch.elements.filter import FilterSingle
from nnstreamer_tpu_torch.filters import tf_import as ttf
from nnstreamer_tpu_torch.filters.tensorflow import TensorFlowFilter
from nnstreamer_tpu_torch.runtime import parse_launch

replay("test_tf_import.py", globals(), only=["TestGraphImport"], subs=(
    ('            FilterSingle(framework="tensorflow", model=str(bad),\n'
     '                         input_spec=TensorsSpec.parse("784:1", '
     '"float32"))',
     '            FilterSingle(framework="tensorflow", model=str(bad),\n'
     '                         input_spec=TensorsSpec.parse("784:1", '
     '"float32"), device="cpu")'),))

FILTERS = 8


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tf")
    return {"mnist": mf.write_mnist_pb(str(d / "mnist.pb")),
            "speech": mf.write_speech_pb(str(d / "speech.pb"),
                                         filters=FILTERS)}


def test_mnist_file_passes_the_jax_structure_check(files):
    """``tests/test_tf_import.py::test_mnist_graph_structure``'s
    assertions on the writer's file, in both packages."""
    for mod in (jtf, ttf):
        g = mod.TFGraph(files["mnist"])
        assert {n.op for n in g.order} == {
            "Placeholder", "Const", "Identity", "MatMul", "Add", "Softmax"}
        assert g.output().name == "softmax"


@pytest.mark.parametrize("batch", [1, 2, 256])
def test_mnist_matches_jax_filter(files, batch):
    x = np.random.default_rng(batch).random((batch, 784)).astype(np.float32)
    dims = f"784:{batch}"
    got = FilterSingle(framework="tensorflow", model=files["mnist"],
                       device="cpu",
                       input_spec=TensorsSpec.parse(dims, "float32")
                       ).invoke([x])[0].numpy()
    want = np.asarray(JSingle(framework="tensorflow", model=files["mnist"],
                              input_spec=JSpec.parse(dims, "float32")
                              ).invoke([x])[0])
    assert got.shape == want.shape == (batch, 10)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mnist_through_parse_launch(files, tmp_path):
    """``tests/test_tf_import.py::test_mnist_through_pipeline_with_labels``
    on the writer's graph, in both packages: raw digit bytes → /255 →
    the tensorflow filter (auto-detected from .pb) → image_labeling."""
    labels = tmp_path / "digits.txt"
    labels.write_text("\n".join(str(d) for d in range(10)) + "\n")
    img = np.random.default_rng(9).integers(0, 256, (1, 784), dtype=np.uint8)
    got = {}
    for pkg, parse, buf, spec in (("jax", jparse, JBuffer, JSpec),
                                  ("port", parse_launch, Buffer,
                                   TensorsSpec)):
        kw = {"device": "cpu"} if pkg == "port" else {}
        p = parse(
            f"appsrc name=src ! tensor_transform mode=arithmetic "
            f"option=typecast:float32,div:255.0 ! "
            f"tensor_filter model={files['mnist']} input=784:1 "
            f"inputtype=float32 ! "
            f"tensor_decoder mode=image_labeling option1={labels} ! "
            "appsink name=out", **kw)
        p["src"].spec = spec.parse("784:1", "uint8", rate=0)
        with p:
            p["src"].push_buffer(buf.of(img))
            p["src"].end_of_stream()
            assert p.wait_eos(timeout=300)
            out = p["out"].pull(timeout=5)
        got[pkg] = bytes(out[0].np()).decode("utf-8").strip("\x00").strip()
    assert got["port"] == got["jax"] and got["port"] in "0123456789"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speech_graph_matches_jax_filter(files, seed):
    clip = mf.seeded_clip(seed)
    pcm, rate = ttf.decode_wav_bytes(mf.wav_bytes(clip))
    jpcm, jrate = jtf.decode_wav_bytes(mf.wav_bytes(clip))
    assert rate == jrate == 16000 and np.array_equal(pcm, jpcm)
    np.testing.assert_array_equal(pcm, clip)
    fs = FilterSingle(framework="tensorflow", model=files["speech"],
                      device="cpu")
    assert fs.in_spec.tensors[0].shape == (16000, 1)
    got = fs.invoke([pcm])[0].numpy()
    want = np.asarray(JSingle(framework="tensorflow",
                              model=files["speech"]).invoke([pcm])[0])
    assert got.shape == want.shape == (1, 12)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_speech_front_end_matches_jax(files):
    """The spectrogram and the mel/DCT stage, function against function."""
    import torch

    pcm = mf.seeded_clip(5)
    spec = ttf.audio_spectrogram(torch.from_numpy(pcm), 480, 160, True)
    jspec = np.asarray(jtf.audio_spectrogram(pcm, 480, 160, True))
    assert tuple(spec.shape) == jspec.shape == (1, 98, 257)
    np.testing.assert_allclose(spec.numpy(), jspec, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jspec).max()))
    m = ttf.mfcc(spec, 16000.0, 4000.0, 20.0, 40, 40).numpy()
    jm = np.asarray(jtf.mfcc(jspec, 16000.0, 4000.0, 20.0, 40, 40))
    np.testing.assert_allclose(m, jm, rtol=1e-4, atol=1e-4)
    short = ttf.audio_spectrogram(torch.zeros(100, 1), 480, 160, True)
    assert tuple(short.shape) == (1, 0, 257)


def _tf_session_run(tf, path, fetches, feed):
    g = tf.compat.v1.GraphDef()
    g.ParseFromString(open(path, "rb").read())
    with tf.Graph().as_default() as graph:
        tf.import_graph_def(g, name="")
        with tf.compat.v1.Session(graph=graph) as sess:
            return sess.run(fetches, feed)


def test_mnist_agrees_with_tf_session(files):
    tf = pytest.importorskip("tensorflow")
    x = np.random.default_rng(1).random((3, 784)).astype(np.float32)
    want = _tf_session_run(tf, files["mnist"], "softmax:0", {"input:0": x})
    got = FilterSingle(framework="tensorflow", model=files["mnist"],
                       device="cpu",
                       input_spec=TensorsSpec.parse("784:3", "float32")
                       ).invoke([x])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_speech_graph_against_tf_session(files):
    """TF runs the writer's speech graph on the WAV bytes.  The
    spectrogram agrees; the convnet agrees when TF's Mfcc output is
    replaced by the importer's; the Mfcc stage itself differs (the JAX
    package's reimplementation, shared by the port)."""
    import torch

    tf = pytest.importorskip("tensorflow")
    clip = mf.seeded_clip(3)
    wav = mf.wav_bytes(clip)
    spec_tf, mfcc_tf = _tf_session_run(
        tf, files["speech"], ["AudioSpectrogram:0", "Mfcc:0"],
        {"wav_data:0": wav})
    pcm, _ = ttf.decode_wav_bytes(wav)
    spec = ttf.audio_spectrogram(torch.from_numpy(pcm), 480, 160, True)
    np.testing.assert_allclose(spec.numpy(), spec_tf, rtol=0,
                               atol=1e-5 * float(np.abs(spec_tf).max()))
    m = ttf.mfcc(spec, 16000.0, 4000.0, 20.0, 40, 40).numpy()
    gap = float(np.abs(m - mfcc_tf).max())
    assert gap > 0.1, "the Mfcc stage now matches TF: update ROADMAP C"
    soft_tf = _tf_session_run(tf, files["speech"], "labels_softmax:0",
                              {"wav_data:0": wav, "Mfcc:0": m})
    got = FilterSingle(framework="tensorflow", model=files["speech"],
                       device="cpu").invoke([pcm])[0].numpy()
    np.testing.assert_allclose(got, soft_tf, rtol=1e-5, atol=1e-5)


def test_framework_autodetect_and_alias(files):
    from nnstreamer_tpu_torch.filters.registry import (
        detect_framework,
        find_filter,
    )

    assert detect_framework(files["mnist"]) == "tensorflow"
    assert issubclass(find_filter("tensorflow2"), TensorFlowFilter)
