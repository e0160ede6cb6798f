"""The concurrency analyzer's tests (``tests/test_concurrency_lint.py``)
replayed on the port's ``nnstreamer_tpu_torch.analyze.concurrency``: every
NNS6xx code's positive, negative and suppression cases, the lock graph of
the port's own package (no cycle), the historical-bug regressions re-run
against the port's ``obs/watch.py``, the ``--concurrency`` JSON golden
byte-equal, and the ``--self --concurrency --strict`` gate over
``nnstreamer_tpu_torch/``."""

from torch_replay import replay

replay("test_concurrency_lint.py", globals())
