"""``tests/test_distributed_obs.py`` replayed on the port: trace contexts
over a query link and a pub/sub hop, the link counters, ``/healthz``,
fleet ``nns-top``, the NTP cross-check, and the frame annotation (the
port's is ``torch.profiler.record_function``, patched where the JAX test
patches ``jax.profiler.TraceAnnotation``)."""

from torch_replay import replay

replay("test_distributed_obs.py", globals(), subs=(
    ("    import jax\n\n    monkeypatch.setattr(jax.profiler, "
     "\"TraceAnnotation\", FakeAnnotation)",
     "    import torch.profiler\n\n    monkeypatch.setattr(torch.profiler, "
     "\"record_function\", FakeAnnotation)"),
))
