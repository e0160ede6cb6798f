from torch_replay import replay
replay("test_obs.py", globals(), only=[
    "test_nns_top_once_smoke", "test_nns_top_over_http_sees_pool",
    "test_nns_top_json_dump"])
