"""``tests/test_chaos.py``'s query-link cases replayed on the port: the
fault plan's wire seam on a real query link (resend at most once, a
disconnect flap, seq-less drops, tombstone expiry), ``mqttsrc`` and
``mqttsink`` reconnecting through a broker restart, and an ``edgesrc``
re-subscribing after its publisher restarts."""

from torch_replay import replay

replay("test_chaos.py", globals(), subs=(
    # the port's delay server: the replayed pipelining module's
    ("from tests.test_query_pipelining import DelayServer",
     "from tests.test_torch_query_pipelining import DelayServer"),
), only=("TestQueryFaults", "TestSelfHealingLinks"))
