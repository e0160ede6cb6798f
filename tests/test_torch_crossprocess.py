"""``tests/test_crossprocess.py`` replayed on the port: a query server
pipeline in a child process (the port's, on the CPU), the client here,
over localhost TCP, with and without a trace crossing."""

from torch_replay import replay

replay("test_crossprocess.py", globals())
