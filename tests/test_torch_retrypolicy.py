from torch_replay import replay
replay("test_chaos.py", globals(), only=["TestRetryPolicy"])
