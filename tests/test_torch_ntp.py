"""``tests/test_ntp.py`` replayed on the port's ``edge/ntputil.py``, with
``mqttsink`` taking the NTP clock as its ``epoch_fn``."""

from torch_replay import replay

replay("test_ntp.py", globals())
