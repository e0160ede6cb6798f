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
    # the tombstone case: wait for request 1's expiry (the 400 ms client
    # timeout) up to a deadline instead of a fixed 0.5 s, which left
    # 100 ms of margin under a loaded run; still exactly one timeout
    ("                time.sleep(0.5)  # request 1 expires (tombstone "
     "parked)\n",
     "                expiry = time.monotonic() + 5.0  # request 1 expires\n"
     "                while cli.timeouts < 1 and time.monotonic() < expiry:\n"
     "                    time.sleep(0.01)   # (tombstone parked)\n"),
), only=("TestQueryFaults", "TestSelfHealingLinks"))
