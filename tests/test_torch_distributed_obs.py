"""``tests/test_distributed_obs.py`` replayed on the port: trace contexts
over a query link and a pub/sub hop, the link counters, ``/healthz``,
fleet ``nns-top``, the NTP cross-check, and the frame annotation (the
port's is ``torch.profiler.record_function``, patched where the JAX test
patches ``jax.profiler.TraceAnnotation``, and the process-wide
``torch.autograd.profiler._is_profiler_enabled`` set where the JAX test
sets its package's private trace flag)."""

from torch_replay import replay

replay("test_distributed_obs.py", globals(), subs=(
    ("    import jax\n\n    monkeypatch.setattr(jax.profiler, "
     "\"TraceAnnotation\", FakeAnnotation)",
     "    import torch.profiler\n\n    monkeypatch.setattr(torch.profiler, "
     "\"record_function\", FakeAnnotation)"),
    # the port's spans open while any profiler session records: the
    # process-wide flag stands for the JAX package's private one
    ("    profile._active.set()\n",
     "    import torch.autograd.profiler as _tap\n\n"
     "    monkeypatch.setattr(_tap, \"_is_profiler_enabled\", True)\n"),
    ("        profile._active.clear()\n",
     "        monkeypatch.undo()\n"),
))
