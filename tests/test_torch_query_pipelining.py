"""``tests/test_query_pipelining.py`` replayed on the port: request
pipelining, out-of-order replies, seq-less pairing with its tombstones,
mid-stream failover."""

from torch_replay import replay

replay("test_query_pipelining.py", globals())
