"""``tests/test_ntp.py`` replayed on the port's ``edge/ntputil.py``.

Left out: ``test_mqtt_sink_accepts_ntp_clock`` (``mqttsink``, the MQTT
slice, ROADMAP item 5b)."""

from torch_replay import replay

replay("test_ntp.py", globals(),
       leave_out=("test_mqtt_sink_accepts_ntp_clock",))
